"""Data substrate: tokenizer, versioned corpus, deterministic pipeline."""
