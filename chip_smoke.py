#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Needs a CUDA card (it exits non-zero without one) and the CUDA toolkit's
nvcc; it builds the port's kernels from ``src/repro_torch/csrc`` into
``build/repro_torch/`` on first use. It prints one JSON object per line:

  env             card, power limit, torch/CUDA versions, kernel build time,
                  ptxas reports (registers and spills per flash kernel,
                  forward and backward) and the flash kernels'
                  tensor-core instructions per kernel (HGMMA, BF16 and
                  TF32; HMMA in flash_mma_kernel; HGMMA BF16 in the
                  backward's flash_bwd_dkdv_wgmma_kernel and
                  flash_bwd_dq_wgmma_kernel, HGMMA TF32 in its
                  flash_bwd_dkdv_wgmma_f32_kernel and
                  flash_bwd_dq_wgmma_f32_kernel)
  kernel          each CUDA kernel at ragged edge shapes (the delta codec
                  at every lane dtype, with extreme values, and on bases 4
                  and 8 bytes past a 16-byte boundary; the route's two
                  entry points at the empty key, trailing-zero and 125+
                  byte keys; the stacked scan at S = 1/3/4, ragged C,
                  boundaries at 0 and C), then at the shapes its path
                  gives it: max |kernel - plain version| (must be 0; the
                  codec compares bits and per-tile stats), kernel / plain /
                  library times, its bound, and for the fingerprint, the
                  route and the keep mask the card's time alone per call
                  (device_ms: calls queued behind a spin kernel)
  kernel_edges_fingerprint  the fingerprint at W 1/2/3/4/5/7/8/9/12/16/17/
                  63/64/65/128/256/300/512, N 1/513/200,003 (a ragged last
                  tile), on
                  bases 0/4/8 bytes past a 16-byte boundary (a row slice
                  of a larger buffer), bit for bit, with each case's plan
  kernel_edges_scan  the single-pass scan at C = 1, a tile - 1, a tile, a
                  tile + 1 and 2^24 + 3, Q = 1/2/8/64, timestamps on the
                  card and (Q <= 8) by value from the host, and two calls
                  back to back, bit for bit
  kernel_edges_decode  chain_decode_at at packed int8/16/32 into stored
                  1/2/4-byte ints, W 1/3/8/64, a misaligned field, the XOR
                  path, int32/int64 indices at 0 and C - 1, an empty index
                  and a 10,000-cell chain; on the 16-byte path, chains of
                  7/8/9/15/16/17 cells across the 8-byte words of head
                  flags, with and without a head at cell 0, flags at
                  bases 0/1/5 bytes past alignment; bit for bit
  main_path       one store at UniProtKB/Swiss-Prot scale (570,000 entries,
                  sequence 64 x int32, length 1 x int32, annotation
                  8 x int32; 8 full releases at ts 10..80 with 3% sequence
                  churn, fresh annotation, 1% new and 0.1% deleted
                  entries): update, get_versions at Q = 1/8/64,
                  get_increments over the 7 release windows, a cold
                  get_version and compact(30), every row checked against
                  the release that produced it; the device memory a
                  Q = 1 query adds; chain decode's launches by the gather
                  size of the call that made them
  chain_decode_memory  the device memory the Q = 1 gather's decode adds,
                  kernel beside its plain version (the full decode); the
                  Q = 1, 8 and 64 gathers' outputs checked against the
                  sequence values
  sharding        route_keys on the last release's keys (and its host
                  packing, key_bytes; key_lanes, off the path, beside it),
                  then the same 8 releases into a ShardedStore of 4 shards
                  (ts 10..40 through update, ts 50..80 through threaded
                  ShardedReleaseSession waves of 4 chunks), get_versions at
                  Q = 1/8 (Q = 64 cut: the line's "reduced") and
                  get_increments over the
                  7 windows under serial and stacked placement (and mesh
                  with 2+ cards), every row checked against its release
                  and byte for byte against an unsharded store's answers;
                  compact(30) and a full save (the lazy reopen and Q = 8
                  after it cut: the line's "reduced")
  serial_vs_stacked_scan  the four per-shard scans the serial placement
                  runs at Q = 64, timed beside the one stacked scan
  sharding_parity a 2,000-entry sharded history saved from device="cpu"
                  and device="cuda": byte-identical SHARD_MANIFEST.json and
                  shard trees
  persistence     the same store built again with save(path) after every
                  release (incremental), a force_full save (with its stage
                  split), a lazy load that reads only the segments a
                  pinned query needs, get_versions at Q = 8 after lazy and
                  eager loads, and compact(30, path=) then a reload, every
                  row checked against its release
  persistence_parity  a 2,000-entry history with int32, uint16 and float32
                  fields saved from device="cpu" and device="cuda":
                  byte-identical MANIFEST.json, index and segment files
  cpu_gpu_parity  a 2,000-entry history through device="cpu" and
                  device="cuda": identical views, increments and digests
  kernel_edges_serving  flash attention at the JAX package's kernel-test
                  shapes, D 8/16/32/64/112/128, f32 and bf16, Sq > Sk and
                  Sq = 1, and at shapes that straddle the tensor-core
                  kernels' tiles (Sq 129 and 300 with Sk - Sq not a
                  multiple of any key tile, Sk 257, GQA groups 1/4/8, B 3,
                  Sk 0, and at D 64 and 128 a strided q and a k whose
                  base TMA cannot read), within FLASH_TOL of its plain
                  version, with the design each case took; the masked
                  merge at N 1/511/512/513, W 1-9, every element size,
                  int32 and int64 timestamps, bit for bit
  kernel_edges_merge  the masked merge at rows of W * s bytes on and off
                  a multiple of 16 (every unit: 16, 8, 4, 2 bytes, one
                  element), bases 0/4/8 bytes past a 16-byte boundary,
                  row masks all false/all true/mixed, field masks
                  none/all/mixed, one and several blocks, W 64 int32 at
                  N 511/512/513, bit for bit
  merge           kops.masked_merge on the first release's sequence table
                  (570,000 x 64 int32) with the second release's rows for
                  the entries whose sequence changed, checked against a
                  numpy select
  gestore         the GeStore facade at a quarter of UniProtKB/Swiss-Prot's
                  scale (its "reduced"): two releases from
                  write_synth_uniprot (143,000 entries; then 144,430, 1%
                  new, churn 0.03)
                  parsed by UniProtParser at
                  its widths (sequence 512 x int8, annotation 256 x int8,
                  length and taxid int32), streamed into a 4-shard store by
                  add_release_stream (journal, pre- and post-release saves;
                  a thread reads version 10 while the second streams, and
                  every read must equal the one before); one
                  generate_files_batch (full versions 10 and 20, the
                  blastp and annot increments, a key filter; under
                  torch.profiler), every file
                  checked against FASTA written from the release text by
                  a regex, the increments' keys against the releases'
                  changed and new entries; the batch again (all cached),
                  merge_files, flush; a new GeStore over the root, its
                  histories checked, cache evicted. Cut in depth (its
                  "reduced"): no batch regenerated by the reopened
                  GeStore, no one-shard store built by add_release of
                  the whole text (gestore_parity keeps one at 20,000
                  entries).
                  Walls (each stream's entries/s, each batch split into
                  increments, size context, full versions and format +
                  cache put), the launches of every kernel, the
                  fingerprint's by row width
  gestore_parity  a 20,000-entry history through GeStore(device="cpu")
                  and GeStore(device="cuda"): identical generated files
                  and store directories after flush; an ingest into a
                  4-shard store on the card killed at half its chunks,
                  reloaded and resumed (journaled chunks replayed), ending
                  at an uninterrupted run's digests; a WorkflowManager
                  incremental run equal to a full run on both devices
  serving         llama3.2-1b at full width and depth (weights drawn from
                  a numpy generator seeded with --seed, loaded through
                  models/weights.py): a Scheduler run of 16 requests of
                  4-47 tokens (max_new 16, max_batch 8, greedy), then one
                  32,768-token request with 16 decode steps through
                  ServeEngine; prefill wall per bucket, decode tokens/s,
                  p50/p99 latency, peak memory and the flash launches
                  (one per layer per prefill), read from each engine
                  call's serve.generate span. The first bucket is checked
                  against the same batch and weights through
                  device="cpu": its prefill logits in bf16
                  (SERVE_TOL_BF16), and in f32 (SERVE_TOL) its prefill
                  and SERVE_CHECK_STEPS decode steps fed the same tokens;
                  the scheduler's first tokens against the card's
                  prefill; the 32k request's ring decode, in f32, against
                  a prefill of the same tokens (SERVE_TOL); and the flash
                  kernel against its plain version on the layer-0 q/k/v
                  that the counted prefills handed it (first bucket and
                  32k prompt). The f32 checks' prefills (the first
                  bucket's, the ring check's two) are counted apart: each
                  of their flash launches must take the f32 tensor-core
                  design
  serving_profile one bucket's generate and the 32k prefill under
                  torch.profiler: device time, idle share, top kernels
  serving_parity  the smoke config (f32) through device="cpu" and
                  device="cuda": the same greedy ids from a Scheduler
                  run, prefill logits within SMOKE_TOL
  frontdoor       the serving tier over two stores of its own built from
                  the main path's releases (a VersionedStore and a
                  4-shard ShardedStore, stacked on the card by
                  shard_placement="parallel"): table9_serving's traffic
                  open loop from one thread per tenant through started
                  FrontDoors (4 reader tenants over both stores at
                  versions 40/60/80, the sequence and length fields or
                  every field; an update of 1% of the keys every 50th
                  request by each store's writer in turn; a
                  compact(30) per store midway), first all at once (the
                  rate the door sustains), then paced at FD_RATE_SHARE
                  of that rate; then the same stores behind a door whose
                  pool has a memory budget between the larger store's
                  host bytes and both stores' resident bytes, with reads
                  in blocks that keep one store hot at a time. Every read
                  equals the store's answer after the drains byte for
                  byte (and the release), no request fails or is shed,
                  each store's mutations resolve in submission order; the
                  budgeted pool demotes, spills (shard by shard too) and
                  reloads; every demotion the pool counts is watched
                  where it is made, one of a store the pool reloaded, and
                  each frees at least FD_DEMOTION_FREED of the device
                  bytes nbytes() counted. p50/p99 latency, achieved
                  against target rate, waves, riders, serial degrades,
                  pool stats and pressure, the device over one read wave
                  of each store (torch.profiler and CUDA-event spans of
                  every device operation), launches
  kernel_edges_scans  the scan kernels against their plain versions
                  within SCAN_TOL: Mamba's selective scan (ssm_scan.cu)
                  at N 8 and 16, x f32 and bf16, d_inner 200 (a ragged
                  channel block), B and C strided or not, and RWKV6's WKV
                  recurrence (wkv.cu) at Dk 16 and 64, each at L 1, 2,
                  127, 128, 129 and 1,000, B 1 and 3, from a nonzero
                  state (at L <= 2 also the decode step's sequential
                  plain version); decays that all underflow to 0; logw at
                  both ends of its clip over 1,000 steps (the slow end at
                  small scale, and at unit scale held against f64)
  families_served Jamba-v0.1 at its published widths (d 4,096, 32 / 8
                  heads of 128, 16 experts top-2, Mamba state 16), 8 of
                  its 32 layers (one period of the 1:7 interleave), weights
                  from a seeded generator on the card, through Scheduler
                  and ServeEngine (the serving phase's 16 requests, 16
                  tokens each), then one 4,096-token prompt at batch 1:
                  walls, decode tokens/s, peak memory, flash launches by
                  design and head dim (flash_wgmma_kernel<128>), the scan
                  kernel's launches (7 Mamba layers x every prefill and
                  decode step, checked), and one profiled prefill of the
                  long prompt (the same weights, in a fresh process) with
                  the device time of the Mamba scan (the kernel's
                  wrapper) and of the MoE's routing, dispatch, expert
                  products and combine
  families_config each other new config at its published widths for one
                  bucket's prefill and 8 greedy decode steps: olmo-1b,
                  qwen1.5-4b, qwen2-0.5b, rwkv6-7b at full depth, grok-1
                  at 2 layers, kimi-k2 at 1 (flash_wgmma_kernel<112>),
                  qwen2-vl-72b at 2 on embeddings with M-RoPE positions;
                  prefill wall, decode tokens/s, peak memory, flash calls
                  by design and head dim (rwkv6-7b: none; its WKV
                  kernel's launches 32 x every prefill and decode step,
                  checked; and its 4,096-token prompt at batch 1, its
                  wall over all 32 layers and a profiled prefill through
                  the first 2, in a fresh process, with the scan's share)
  families        the above in brief, and the nine new smoke configs in
                  f32 through device="cpu" and device="cuda": the same
                  greedy ids from a Scheduler run (qwen2-vl and
                  whisper: greedy steps through ModelBundle on
                  embeddings and on audio frames) and prefill
                  logits within SMOKE_TOL, with the card run's kernel
                  launches (counted from 0) and its flash calls by design
                  and head dim, which must add up to the launches
                  (flash_mma_f32_kernel at D 16 and 8); jamba-smoke and
                  rwkv6-smoke through the scan kernels (N 8 with f32 x,
                  Dk 16), no other config launching one
  kernel_edges_whisper  flash forward and backward at whisper's heads
                  (H 16 / K 16, D 64) and lengths 4, 224 and 448, bf16
                  and f32, against the plain versions, with the designs
  whisper         whisper-medium at its published widths, all 24 + 24
                  layers (811.3 M parameters, seeded on the card): 8
                  clips of 1,500 frame embeddings, the 4-token
                  start-of-transcript prompt, 128 greedy tokens through
                  ModelBundle.prefill / decode, a 224-token prefill;
                  encode, prefill and decode walls, peak memory, flash
                  launches by design and head dim (24 a prefill, all
                  wgmma<64>), one prefill profiled in a fresh process
                  with the encoder attention's share; four Trainer steps
                  at B 4 x 448 tokens + 1,500 frames (AdamW, chunked,
                  remat): walls, tokens/s, peak memory, losses, launches
                  by design; a 2 + 2-layer f32 copy at the published
                  widths on the CPU and the card: ids equal, logits
                  within SMOKE_TOL, loss and gradients within BWD_TOL
  search          table4_application at Swiss-Prot scale: 570,000
                  sequences (32 x int32) and a release at 3.1% churn, the
                  Meta-pipe encoder at its published widths in bf16
                  (seeded random weights, flash_mma_kernel at D 32, on
                  the tensor cores by mma.sync) mean-pooled in batches
                  of 4,096, EmbeddingSearchDB (seg_size 64, tau 4, 8
                  queries, k 10): a full refresh
                  and query, the incremental query to version 2 equal to
                  a full recompute bit for bit, only the changed rows
                  embedded; the encoder's chunked hidden states against
                  xla within bf16's own rounding, and in f32 (its flash
                  launches all flash_mma_f32_kernel, three TF32 products
                  by mma.sync) within ENCODER_F32_TOL of f32 xla; a
                  VersionedCorpus of
                  20,000 documents released twice (only changed and new
                  documents tokenized, token streams equal to a full
                  release's). Walls, rows embedded, flash launches by
                  design, the device over the full query
  kernels         per kernel: launches during the path that runs it,
                  error, times, bound (flash attention twice at 32k: bf16,
                  and f32 on the tensor cores as three TF32 products, its
                  launches those of the serving phase's f32 checks; the
                  scan twice: Q = 64, and Q = 1 with its single-query
                  launches; chain decode at the main path's Q = 1, 8 and
                  64 gathers, each with its gathers' launches; the masked
                  merge in alternating rounds with the torch.where pair,
                  bound by the bytes its masks need and, beside it, by
                  both operands read;
                  the codec's rows timed in alternating rounds with their
                  library calls, and the int32 packs' device time per
                  call with no host time in it, beside torch.sub's; the
                  route twice: from flat key bytes, the sharding path's,
                  and from padded lanes, launched by no path; device_ms
                  for the fingerprint, both routes and the keep mask;
                  the fingerprint also at UniProt's int8 rows, W 512 and
                  256 lanes at N 143,000, with the gestore path's
                  launches at each width; flash attention at the
                  Meta-pipe encoder's shape, B 4,096 x S 32 x H 8, in
                  alternating rounds with SDPA and with its device time
                  alone: bf16 at D 32 (flash_mma_kernel, its launches the
                  search path's), f32 at D 32 (flash_mma_f32_kernel, its
                  launches the encoder check's f32 run), and two shapes
                  no path launches: D 16 in bf16 (flash_mma_kernel) and
                  in f32 (flash_mma_f32_kernel, its launches the families
                  phase's f32 smoke checks); flash attention at the
                  families' shapes: bf16 D 128 on Jamba's 4,096-token
                  prefill (layer 4), bf16 D 112 at kimi-k2's B 1 x S
                  4,096, H 64 / K 8, D 8 at qwen2-0.5b-smoke's f32
                  prefill on the card and the same values in bf16 (no
                  path)),
                  and the frontdoor phase's launches, the distributed
                  phase's flash launches (rank 0's llama3.2-1b and
                  qwen2-0.5b runs), and the seconds
                  since the start at which each phase's line was printed;
                  the flash backward's three kernels (delta, dkdv, dq) at
                  llama3.2-1b's training layer, B 2 x S 4,096, H 32 / K 8,
                  D 64 (its q, k, v, o and lse, a seeded unit-scale dO),
                  in bf16 (flash_bwd_dkdv_wgmma_kernel and
                  flash_bwd_dq_wgmma_kernel on the tensor cores, the
                  train path's launches) and f32
                  (flash_bwd_dkdv_wgmma_f32_kernel and
                  flash_bwd_dq_wgmma_f32_kernel, three TF32 products of
                  split operands, the f32 parity check's),
                  with SDPA's backward beside them; the same three at
                  olmo-1b's attention, H 16 / K 16, D 128, B 2 x S 4,096,
                  in bf16 (_d128) and f32 (_d128_f32), launched by no
                  path; the bf16 forward at the train path's shape with
                  the lse written (flash_attention_train, its launches
                  the train path's); and the wgmma forward rows at 32k
                  and at the train shape timed with a null lse pointer
                  and with one, in alternating rounds; flash at whisper's
                  decoder shapes: bf16 and f32 at B 8 x S 224, H 16 /
                  K 16, D 64 (flash_attention_whisper and _whisper_f32,
                  the whisper phase's launches) and the bf16 backward at
                  B 4 x S 448 (flash_bwd_*_whisper, its training's; a
                  seeded unit-scale dO);
                  the backward at kimi-k2's training shape, B 1 x S
                  4,096, H 64 / K 8, D 112 (flash_bwd_*_d112, the
                  families_train path's: its q, k, v, o and lse, a
                  seeded unit-scale dO), and the mma designs' backward
                  at the Meta-pipe encoder's shape, D 32 and 16 in bf16
                  and f32 (flash_bwd_*_d32, _d16, _d32_f32, _d16_f32; D
                  16 the families_train smoke steps', D 32 no path's);
                  the four encoder-shape forward rows also with a null
                  lse and with the lse written, in alternating rounds;
                  the scan kernels at the families' shapes (ssm_scan on
                  Jamba-v0.1's first Mamba layer of its 4,096-token
                  prefill, its launches the families_served path's; wkv
                  on rwkv6-7b's layer 0 of its 4,096-token prefill, its
                  launches that config's run), each with the kernel's
                  and the plain chunked version's largest error against
                  the sequential recurrence in f64 (f64), the kernel's at
                  most SCAN_F64_FACTOR times the plain version's; their
                  bounds: bytes against f32 operations, the selective
                  scan's exponentials split between the SFU and the FMA
                  pipe (exp_bound_s; on the SFU alone beside it)
  kernel_edges_train  the flash backward's kernels at D 8/16/32 (the mma
                  designs) and 64/112/128 (wgmma, D 112 in D 128's
                  tiles), f32 and bf16, GQA groups 1/4 (and 7 heads over
                  one at D 8 to 32, kimi-k2's 64 over 8 at D 112),
                  S 1/127/128/129/1,000, Sq < Sk,
                  Sq > Sk (rows that see no key: gradient 0), a
                  transposed and a padded (copied) q, each against the
                  plain backward within BWD_TOL, every case on the
                  kernels of its (dtype, D)'s design (counted by design;
                  worst error per design); every design's forward lse
                  against the plain version's (LSE_TOL); the plain
                  backward against f64 autograd through ref_attention;
                  the autograd path (and a scalar loss's zero-stride dO)
                  giving q, k and v the kernels' gradients at every head
                  dim
  train           llama3.2-1b at the published dims, bf16, RunConfig()
                  defaults (AdamW, chunked, nothing_saveable remat) through
                  Trainer.run_loop: 6 steps on one repeated batch of
                  B 2 x S 4,096, the last under torch.profiler; every loss
                  finite and the last below the first; flash forward
                  launches 32 a step (a forward and a remat recompute per
                  layer), all wgmma, and 16 a step of each backward
                  kernel, all 96 of dkdv's and of dq's on the wgmma
                  design; step walls, tokens/s, peak device memory
  train_parity    chunked against xla on the same parameters: the full
                  model in bf16 at B 2 x S 2,048 (loss, gradient norm and
                  each layer's wq, wk and wv gradients within
                  PARITY_TOL_BF16), then a full-width 2-layer copy in f32
                  (every gradient leaf within PARITY_TOL_F32)
  train_checkpoint  a Trainer with ckpt_every=1 on llama3.2-1b cut to
                  CKPT_DIMS (2 layers, d 512, d_ff 1,024, vocab 8,192;
                  the rows keep their 2,048 f32 lanes; the cut is the
                  line's "reduced"): two delta checkpoints into a
                  VersionedStore on the card, each restored bit for bit,
                  also through a fresh CheckpointManager; save and
                  restore walls, stats(), the store kernels' launches.
                  tools/torch_train_ckpt_probe.py runs the full-width
                  save (4-5 minutes of host deflate a save)
  families_train  kimi-k2 at its published widths trained on one card
                  (d 7,168, 64 / 8 heads of 112, vocab 163,840, top-8 of
                  64 experts of 2,048, capacity 1.25; 1 of its 61 layers
                  and 64 of its 384 experts, the line's "reduced"),
                  Adafactor, B 1 x S 4,096, initialised on the card from
                  the seed: chunked against xla on the same parameters
                  and batch (loss, gradient norm, the relative L2
                  distance of the layer's wq, wk and wv gradients within
                  PARITY_TOL_BF16), and the backward kernels against
                  their plain version on the plain forward (within
                  KIMI_BWD_TOL_BF16; beside, the chunked path through the
                  plain versions alone, a witness that launches
                  nothing), then 3 Trainer
                  steps, the last under torch.profiler: losses, walls,
                  tokens/s, peak memory, idle share, flash launches by
                  design and head dim (each step wgmma<112> twice, one
                  delta, dkdv and dq on the wgmma backward at D 112); the
                  nine FAMILY_SMOKE configs in f32, one Trainer step each
                  (RunConfig() defaults: chunked) on the CPU and the
                  card from one random tree: losses within SMOKE_TOL,
                  every gradient leaf within FAMILY_GRAD_TOL, the
                  backward launched on the mma_f32 kernels (D 16; D 8 for
                  qwen2-0.5b; none for rwkv6), no scan kernel launched
                  (training runs the scans as torch ops); kimi-k2's
                  smoke config in
                  bf16 on the card, chunked against xla (the bf16 mma
                  backward)
  distributed     the sharded paths, each rank a process of its own on a
                  card of its own (NCCL, a FileStore in the build tree;
                  the kernels the parent built): 4 ranks from 4 cards
                  up, else one rank on (1, 1) meshes
                  (tools/torch_dist_probe.py: ranks cannot share a card
                  over gloo). llama3.2-1b at its published widths on
                  (data 2, model 2) and qwen2-0.5b on (data 1, model 4)
                  (its 14 heads: the sequence-parallel branch), each
                  DIST_STEPS / DIST_QWEN_STEPS train steps at B 2 x S
                  4,096 (RunConfig() defaults) with the state laid out by
                  the sharding rules, against the unsharded step on the
                  same card, weights and batch: losses and gradient
                  norms equal on one rank (within DIST_LOSS_TOL_RANKS /
                  DIST_NORM_TOL_RANKS on several), step walls, each
                  rank's peak memory, the
                  flash launches per rank (a forward and a
                  remat recompute per layer and step, one of each
                  backward kernel), the collectives of llama's last step
                  (op, bytes, group); grok-1's MoE block at its published
                  widths on (data 2, model 2) over 4,096 tokens against
                  apply_moe on each data shard and each (data shard,
                  peer)'s _moe_local summed (equal; the aux loss within
                  MOE_AUX_TOL_RANKS on several ranks);
                  podwise_mean of compressed gradients on (pod 2, data
                  2) within the int8 bound; llama3.2-1b cut to CKPT_DIMS
                  saved sharded and restored by remesh onto 2 ranks, bit
                  for bit. The backend, ranks, ranks per card and meshes
                  are on the line
  tiles           launch.sweep on the card for the route (606,894 keys,
                  4 shards) and the keep mask (4,706,255 cells) over the
                  tiles each can launch, every candidate's output bit for
                  bit against the plain version (a kernel line each),
                  the winners in a cache under a temporary build/
                  directory, a second sweep answered from it and
                  tile_for returning the winner; the codec's tile stays
                  the default

then the card's name and power limit as nvidia-smi prints them, and last
``{"ok": true, "device": {...}}``. Any mismatch or error ends the run with a
traceback, a non-zero exit and no ``ok`` line. Data comes from numpy
generators seeded with ``--seed``.
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import cProfile
import dataclasses
import gc
import json
import math
import os
import pstats
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

N_ENTRIES = 570_000
SEQ_W, ANN_W = 64, 8
RELEASE_TS = [10, 20, 30, 40, 50, 60, 70, 80]
SEQ_CHURN, NEW_FRAC, DEL_FRAC = 0.03, 0.01, 0.001
COMPACT_TS = 30
PARITY_ENTRIES = 2_000
TIMED_REPS = 20  # back-to-back calls per kernel time
# rounds of kernel, then library, for a kernel whose lead over its library
# call is within the run's noise (the Q = 1 scan, the codec): its times are
# the medians of the rounds
TIMED_ROUNDS = 9
SPIN_CYCLES = 20_000_000  # about 10 ms of a spin kernel, ahead of queued calls
GATHER_CHUNK = 1 << 22  # cells per chunk when a gather is checked
# kernel -> (its CUDA source, the TPU kernel of the JAX package it replaces)
SOURCES = {
    "fingerprint": ("src/repro_torch/csrc/fingerprint.cu",
                    "src/repro/kernels/fingerprint.py:29"),
    # the same wrapper at UniProt's int8 rows, one lane an int8 (the
    # gestore phase's sequence and annotation fields)
    "fingerprint_w512": ("src/repro_torch/csrc/fingerprint.cu",
                         "src/repro/kernels/fingerprint.py:29"),
    "fingerprint_w256": ("src/repro_torch/csrc/fingerprint.cu",
                         "src/repro/kernels/fingerprint.py:29"),
    # the route of the store's path: flat key bytes + offsets
    "shard_route_bytes": ("src/repro_torch/csrc/shard_route.cu",
                          "src/repro/kernels/shard_route.py:40"),
    "masked_cumsum": ("src/repro_torch/csrc/masked_cumsum.cu",
                      "src/repro/kernels/batched_select.py:50"),
    # the same wrapper at one query (its launches: the Q = 1 calls)
    "masked_cumsum_q1": ("src/repro_torch/csrc/masked_cumsum.cu",
                         "src/repro/kernels/version_select.py:30"),
    "stacked_masked_cumsum": ("src/repro_torch/csrc/masked_cumsum.cu",
                              "src/repro/kernels/batched_select.py:115"),
    "shard_route": ("src/repro_torch/csrc/shard_route.cu",
                    "src/repro/kernels/shard_route.py:40"),
    "keep_mask": ("src/repro_torch/csrc/keep_mask.cu",
                  "src/repro/kernels/compact_rewrite.py:35"),
    "delta_pack": ("src/repro_torch/csrc/delta_codec.cu",
                   "src/repro/kernels/delta_codec.py:56 and :63"),
    "delta_unpack": ("src/repro_torch/csrc/delta_codec.cu",
                     "src/repro/kernels/delta_codec.py:69 and :74"),
    "delta_pack_wide": ("src/repro_torch/csrc/delta_codec.cu",
                        "src/repro/kernels/delta_codec.py:154 and :179"),
    "delta_unpack_wide": ("src/repro_torch/csrc/delta_codec.cu",
                          "src/repro/kernels/delta_codec.py:166 and :179"),
    "masked_merge": ("src/repro_torch/csrc/masked_merge.cu",
                     "src/repro/kernels/masked_merge.py:24"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:33"),
    # the same wrapper at f32: the f32 tensor-core kernel of the source
    "flash_attention_f32": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:33"),
    # the same wrapper at the Meta-pipe encoder's shape: bf16 at D 32 and
    # 16 (the mma kernel of the source), f32 at D 32 and 16 (its mma_f32
    # kernel)
    "flash_attention_d32": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:33"),
    "flash_attention_d16": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:33"),
    "flash_attention_d32_f32": ("src/repro_torch/csrc/flash_attention.cu",
                                "src/repro/kernels/flash_attention.py:33"),
    "flash_attention_d16_f32": ("src/repro_torch/csrc/flash_attention.cu",
                                "src/repro/kernels/flash_attention.py:33"),
}
# the same wrapper at the families' shapes: bf16 D 128 at Jamba's 4,096-
# token prefill (flash_wgmma_kernel<128>), bf16 D 112 at kimi-k2's
# attention (flash_wgmma_kernel<112>), D 8 at qwen2-0.5b-smoke's shape in
# f32 (flash_mma_f32_kernel<8>, the smoke checks' path) and bf16
# (flash_mma_kernel<8>, no path)
for _sfx in ("_d128_4k", "_d112", "_d8_f32", "_d8"):
    SOURCES[f"flash_attention{_sfx}"] = SOURCES["flash_attention"]
# the flash backward (no TPU kernel: the JAX package differentiates its
# XLA scan), at llama3.2-1b's training layer in bf16 (the train path's
# launches) and in f32 (the f32 chunked-against-xla check's)
_BWD_REPLACES = ("none: src/repro/models/attention.py:89 (_chunked_attention, "
                 "differentiated by JAX autodiff, not Pallas)")
# and at olmo-1b's attention (D 128), in both dtypes, launched by no path
for _k in ("delta", "dkdv", "dq"):
    for _sfx in ("", "_f32", "_d128", "_d128_f32"):
        SOURCES[f"flash_bwd_{_k}{_sfx}"] = (
            "src/repro_torch/csrc/flash_attention_bwd.cu", _BWD_REPLACES)
# the bf16 forward at the train path's shape, the lse written
SOURCES["flash_attention_train"] = SOURCES["flash_attention"]
# the backward at the new head dims: D 112 at kimi-k2's training shape
# (bf16, the families_train path's launches), and the mma designs' at the
# Meta-pipe encoder's shape, D 32 and 16 in bf16 and f32 (D 16: the
# families_train smoke steps' launches; D 32: no path)
for _k in ("delta", "dkdv", "dq"):
    for _sfx in ("_d112", "_d32", "_d16", "_d32_f32", "_d16_f32"):
        SOURCES[f"flash_bwd_{_k}{_sfx}"] = (
            "src/repro_torch/csrc/flash_attention_bwd.cu", _BWD_REPLACES)
# whisper-medium's decoder: bf16 at B 8 x S 224, H 16 / K 16, D 64 (its
# serving prefills' and training forwards' launches), the same values in
# f32 (the f32 copy's), and the bf16 backward at B 4 x S 448 (training's)
SOURCES["flash_attention_whisper"] = SOURCES["flash_attention"]
SOURCES["flash_attention_whisper_f32"] = SOURCES["flash_attention"]
for _k in ("delta", "dkdv", "dq"):
    SOURCES[f"flash_bwd_{_k}_whisper"] = (
        "src/repro_torch/csrc/flash_attention_bwd.cu", _BWD_REPLACES)
# the packed gather's decode, one row per gather size of the main path
# (Q = 1, 8 and 64 timestamps a get_versions call)
DECODE_ROWS = {1: "chain_decode", 8: "chain_decode_q8", 64: "chain_decode_q64"}
SOURCES.update(dict.fromkeys(DECODE_ROWS.values(), (
    "src/repro_torch/csrc/chain_decode.cu",
    "src/repro/kernels/delta_codec.py:261 (chain_decode, a "
    "jax.lax.associative_scan, not Pallas)")))
# the scan kernels (no TPU kernel: the JAX package runs both recurrences
# as jax.lax.associative_scan over chunks, its TPU form of the CUDA kernels
# these are), at Jamba-v0.1's first Mamba layer and rwkv6-7b's layer 0 of
# a FAMILY_LONG-token prefill
SOURCES["ssm_scan"] = (
    "src/repro_torch/csrc/ssm_scan.cu",
    "src/repro/models/ssm.py:91 (ssm_scan_chunked, a "
    "jax.lax.associative_scan, not Pallas; :135 ssm_scan_sequential in "
    "decode)")
SOURCES["wkv"] = (
    "src/repro_torch/csrc/wkv.cu",
    "src/repro/models/rwkv.py:122 (wkv_chunked, a jax.lax.associative_scan, "
    "not Pallas; :109 wkv_sequential)")
# the kernels each driven path must launch at least once
PATH_KERNELS = {
    "main_path": ("fingerprint", "masked_cumsum", "keep_mask",
                  "chain_decode"),
    "persistence": ("fingerprint", "masked_cumsum", "keep_mask",
                    "delta_pack"),
    "sharding": ("fingerprint", "shard_route_bytes",
                 "stacked_masked_cumsum", "masked_cumsum", "keep_mask",
                 "delta_pack"),
    "merge": ("masked_merge",),
    "serving": ("flash_attention",),
    "gestore": ("fingerprint", "masked_cumsum", "shard_route_bytes",
                "delta_pack"),
    "frontdoor": ("fingerprint", "masked_cumsum", "stacked_masked_cumsum",
                  "keep_mask", "shard_route_bytes", "chain_decode",
                  "delta_pack"),
    "search": ("flash_attention", "masked_cumsum", "fingerprint"),
    "train": ("flash_attention", "flash_bwd_delta", "flash_bwd_dkdv",
              "flash_bwd_dq"),
    "families_train": ("flash_attention", "flash_bwd_delta",
                       "flash_bwd_dkdv", "flash_bwd_dq"),
    "train_checkpoint": ("fingerprint", "masked_cumsum", "delta_pack"),
    "families": ("flash_attention", "ssm_scan", "wkv"),
    "whisper": ("flash_attention", "flash_bwd_delta", "flash_bwd_dkdv",
                "flash_bwd_dq"),
    "tiles": ("shard_route_bytes", "keep_mask"),
}
ARCH = "llama3.2-1b"
SERVE_REQUESTS, SERVE_MAX_NEW, SERVE_MAX_BATCH = 16, 16, 8
LONG_PROMPT = 32_768  # prefill_32k's length, at batch 1 instead of 32
# the full model's logits on the card against the same batch and weights
# on the CPU (|logit| is a few units at this init). f32: the same
# arithmetic, summed in another order. bf16: both round to 8 significant
# bits at every product and norm, at other places, over 16 layers; the
# run also reports the card's bf16 against its f32 logits, the same spread
SERVE_TOL = 1e-3
SERVE_TOL_BF16 = 0.25
SERVE_CHECK_STEPS = 4  # f32 decode steps of the first bucket on both sides
SMOKE_TOL = 1e-4  # f32 logits, card against CPU (sums in another order)
# the scan kernels against their plain versions (the edge cases): |got -
# want| <= 1e-5 + 1e-5 |want|, tests/test_torch_model_mixers.py's
# tolerance: the same f32 recurrence, summed in another order. Its atol
# holds where the state stays within a few units (kernel_edges_scans'
# inputs); over a long prompt both drift from the exact value, so there
# each is held against an f64 run (SCAN_F64_FACTOR)
SCAN_TOL = (1e-5, 1e-5)
# a scan kernel's largest error against f64 may be this many times the
# plain chunked version's (else within SCAN_TOL of f64)
SCAN_F64_FACTOR = 2.0
# the special-function units' ex2 rate: 16 a clock on each of the 132 SMs
# at the 1.98 GHz boost clock (the selective scan takes one exponential an
# element of (B, L, d_inner, N))
SFU_EX2_PER_S = 16 * 132 * 1.98e9
# an exponential run on the FMA pipe instead, as FlashAttention-3 splits
# them: a Cody-Waite exp2 (floor and subtract, a degree-5 polynomial's 5
# FMAs at 2 operations each, the exponent's shift and add), in f32
# operations
EXP_POLY_OPS = 14


def exp_bound_s(exps: float, other_ops: float, peak_ops: float) -> float:
    """The least time for ``exps`` exponentials beside ``other_ops`` f32
    operations at ``peak_ops`` a second, each exponential on the
    special-function units (SFU_EX2_PER_S) or as EXP_POLY_OPS operations
    beside the rest: the split that ends both pipes together, or all on
    the units where the other work alone outlasts them."""
    if other_ops / peak_ops >= exps / SFU_EX2_PER_S:
        return other_ops / peak_ops
    return ((other_ops + EXP_POLY_OPS * exps)
            / (peak_ops + EXP_POLY_OPS * SFU_EX2_PER_S))
# the Meta-pipe encoder in f32 on the card, chunked (the mma_f32 flash
# kernel) against xla (torch ops), relative to max(1, max |xla|): the
# same f32 arithmetic with attention's sums in another order, carried
# through four layers
ENCODER_F32_TOL = 1e-4
# flash kernel against its plain version: |got - want| <= atol + rtol *
# |want|. f32: sums in another order. bf16: both round the same f32
# result, which may straddle a rounding boundary: one bf16 ulp (2^-7 of
# the value) apart
FLASH_TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (1e-5, 2**-7)}
PLAIN_FLASH_TILE = 1024  # the plain version's (bq, bk) tiles on the card
# the train phase: llama3.2-1b at the published dims, B 2 x S 4,096 (what
# launch/train.py picks at --seq 4096: chunked), RunConfig() defaults
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 4096, 6
PARITY_SEQ = 2048      # chunked against xla, full depth, bf16
PARITY_F32_LAYERS = 2  # and at f32 on a full-width copy of this depth
# the backward's D 128 rows, launched by no path: olmo-1b's attention
# (src/repro/configs/olmo_1b.py:6-7, 16 heads of 128, no GQA) at the train
# phase's B 2 x S 4,096: (H, K, D)
BWD_D128_HEADS = (16, 16, 128)
# the delta checkpoints' model, cut in depth and width: a save of the
# full-width model deflates 1.3 GB of f32 rows on the host even at one
# layer, 4-5 minutes a save on the card's host (PERF.md;
# tools/torch_train_ckpt_probe.py measures it)
CKPT_DIMS = dict(n_layers=2, d_model=512, n_heads=8, n_kv_heads=2,
                 head_dim=64, d_ff=1024, vocab=8192)
CKPT_SEQ = 1024
# the distributed phase: llama3.2-1b's and qwen2-0.5b's sharded steps at
# TRAIN_BATCH x TRAIN_SEQ, grok-1's MoE block on MOE_TOKENS tokens
DIST_STEPS, DIST_QWEN_STEPS, MOE_TOKENS = 3, 2, 4096
# a sharded step's loss and gradient norm against the unsharded step's on
# the same card and weights, relative, and the sharded MoE block against
# its references. One rank ((1, 1) meshes) runs the unsharded ops on whole
# tensors: equal, bit for bit. Four ranks on four cards sum partial
# products in another order: at most 9.85e-5 of the loss and 1.20e-3 of
# the gradient norm, the MoE block's output equal and its aux loss 6e-8
# apart (tools/dist_phase.py on 4 H100s); the tolerances are 4x those
DIST_LOSS_TOL_RANKS = 4e-4
DIST_NORM_TOL_RANKS = 5e-3
MOE_AUX_TOL_RANKS = 1e-6
DIST_TIMEOUT_S = 480
# flash backward kernels against their plain version, |got - want| <=
# atol + rtol |want|. f32: every sum f32, in another order (dK and dV sum
# G Sq terms). bf16: both round the same f32 result, one bf16 ulp (2^-7
# of the value) apart, on top of the f32 term. delta is f32 either way.
BWD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-4, 2**-7 + 1e-5)}
LSE_TOL = (1e-5, 1e-5)  # the kernels' lse against the plain version's
# a smoke config's training step in f32 on the card against the same step
# on the CPU (families_train): every gradient leaf, |card - cpu| <= atol +
# rtol max |cpu leaf|. The same f32 arithmetic (the card's matrix products
# in full f32, the flash kernels' three TF32 products carrying f32
# precision) summed in another order through the whole model: the
# backward kernels' own f32 tolerance, BWD_TOL[f32], each leaf held as
# whisper's f32 copy is; the loss within SMOKE_TOL
FAMILY_GRAD_TOL = BWD_TOL[torch.float32]
# chunked (the flash kernels, forward and backward) against xla (torch
# ops) end to end on the same parameters and batch, relative to the xla
# value's largest magnitude: loss, gradient norm and each layer's wq, wk
# and wv gradients. bf16: each layer's attention output rounds to bf16
# from f32 results summed in another order, over 16 layers; the limits
# sit a few times above the readings in PERF.md. f32: the same f32
# arithmetic, 2 layers.
PARITY_TOL_BF16 = {"loss": 1e-4, "grad_norm": 2e-3, "wq": 5e-2, "wk": 5e-2,
                   "wv": 5e-2}
PARITY_TOL_F32 = 1e-4
# the same at a smoke config's widths in bf16 (kimi-k2-smoke, d 64, 2
# layers, families_train): a 64-wide model's gradients carry bf16's
# rounding with no averaging over width, and chunked's delta reads the
# bf16 output where xla's autograd has the f32 one. With no kernel on
# either side (both in torch ops on the CPU) the same comparison reads a
# loss 3.5e-4, a gradient norm 1.9e-3 and wq / wk / wv 0.061 / 0.044 /
# 0.034 apart; the limits are about four times those
SMOKE_PARITY_TOL_BF16 = {"loss": 2e-3, "grad_norm": 1e-2, "wq": 0.25,
                         "wk": 0.25, "wv": 0.25}
# kimi-k2 at its published widths, one layer (families_train): the
# chunked path's plain forward with the backward kernels against the
# same with the plain backward (PlainFlashFn) on the same parameters and
# batch, relative as in PARITY_TOL_BF16 (loss, norm; each of wq / wk /
# wv by its largest element and by its L2 norm). The same forward, so
# the loss is equal; the gradients differ by the kernels' bf16 roundings
# of dQ, dK and dV (BWD_TOL's ulp). The limits are about four times the
# H100 readings in PERF.md (norm 1.1e-6; wq 0.0055 and 7.8e-4, wk and wv
# at most 0.0041 and 5.8e-4)
KIMI_BWD_TOL_BF16 = {"loss": 1e-6, "grad_norm": 5e-6, "wq_rel": 0.02,
                     "wk_rel": 0.02, "wv_rel": 0.02, "wq_rel_l2": 3e-3,
                     "wk_rel_l2": 3e-3, "wv_rel_l2": 3e-3}
N_SHARDS = 4  # the JAX package's default shard count
# the fingerprint's edge cases: widths on every path of its plan (rows,
# 16-byte and 4-byte tiles, chunks past 128 lanes), row counts (200,003: a
# ragged last tile and several tiles a block), bases past 16-byte alignment
FP_EDGE_W = (1, 2, 3, 4, 5, 7, 8, 9, 12, 16, 17, 63, 64, 65, 128, 256, 300,
             512)
FP_EDGE_N = (1, 513, 200_003)
FP_EDGE_OFFSETS = (0, 4, 8)
CODEC_DTYPES = ("int8", "int16", "uint16", "int32", "uint32", "float16",
                "float32", "int64", "float64")
INT32 = np.iinfo(np.int32)
DEV = "cuda"


T_START = time.perf_counter()
# [phase, seconds since start] as each phase's line is printed (the kernel
# rows' lines aside): the kernels line carries it, the script's breakdown
PHASE_ENDS: list = []


def emit(obj) -> None:
    """Print one JSON line; a phase's line (not a kernel row) also carries
    ``t_s``, the seconds since the start, as PHASE_ENDS records it."""
    if obj.get("phase", "kernel") != "kernel":
        t = time.perf_counter() - T_START
        PHASE_ENDS.append([obj["phase"], t])
        obj = {**obj, "t_s": t}
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def sync() -> None:
    torch.cuda.synchronize()


def wall(fn):
    """(result, host seconds) of ``fn`` run to completion on the card."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` back-to-back
    calls (after one warm-up), by CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sync()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of ``fn`` over ``reps`` calls
    queued behind a spin kernel (after one warm-up), by CUDA events: the
    card's time for the calls and the gaps between them, with no call's
    host time in it."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sync()
    torch.cuda._sleep(SPIN_CYCLES)  # outlasts the host's queueing
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


# the host calls that put a kernel, a copy or a memset on the card
ENQUEUE_CALL = re.compile(r"^cu(da)?(LaunchKernel|LaunchCooperativeKernel|"
                          r"Memcpy|Memset)")


@contextlib.contextmanager
def device_spans():
    """Bracket every device operation enqueued from this thread by a pair
    of CUDA events on the current stream: each aten op with a tensor on
    the card among its arguments or results (a TorchDispatchMode), and
    each call of a port kernel's launcher (the ctypes entry points that
    ``_build.kernel_fn`` hands out). Yields a dict that holds, after the
    block, ``busy_s``, the summed spans on the card's own clock, and
    ``spans``. Ops on one stream run in order, so the spans do not
    overlap; a span also holds its op's host dispatch time when the card
    waits on the host (on an H100 about 70 us: the 44,873 spans of the
    search phase's full query summed 3.34 s where torch.profiler kept
    0.151 s of device time with 99.9% of the events), so ``busy_s`` is an
    upper bound, close only for calls of few large operations."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from repro_torch.kernels import _build
    pairs, out = [], {}

    def bracket(call):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        res = call()
        b.record()
        return a, b, res

    class Spans(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            a, b, res = bracket(lambda: func(*args, **(kwargs or {})))
            if any(isinstance(x, torch.Tensor) and x.is_cuda
                   for x in tree_leaves((args, kwargs, res))):
                pairs.append((a, b))
            return res

    kernel_fn = _build.kernel_fn

    def bracketed_kernel_fn(*key):
        fn = kernel_fn(*key)

        def launch(*args):
            a, b, rc = bracket(lambda: fn(*args))
            pairs.append((a, b))
            return rc
        return launch

    _build.kernel_fn = bracketed_kernel_fn
    try:
        with Spans():
            yield out
    finally:
        _build.kernel_fn = kernel_fn
    sync()
    out["busy_s"] = sum(a.elapsed_time(b) for a, b in pairs) / 1e3
    out["spans"] = len(pairs)


def device_profile(fn, spans: bool = False,
                   plain_wall_s: float | None = None) -> dict:
    """One run of ``fn`` under torch.profiler: host wall, summed device
    time of every kernel and copy the profiler kept, the device's idle
    share of the wall, the largest device consumers (ms), and the kernels,
    copies and memsets the host enqueued (``enqueued``) beside the device
    events the profiler kept (``device_events``).

    On the H100 machines kineto drops device events whose timestamps it
    places outside its trace window (its log counts them as
    "Out-of-range"), erratically, from about a minute into a process, for
    short and long windows alike: where ``complete`` is false, device_s is
    a lower bound and the idle share an upper bound.

    Idle shares are taken over ``plain_wall_s``, the wall of the same
    call run alone, when it is given (the instruments lengthen only the
    gaps between device operations), else over this run's wall.
    With ``spans``, the same run is also bracketed by :func:`device_spans`:
    ``busy_s`` is the card's busy time on its own clock, which no trace
    window drops, and ``busy_idle_share`` is 1 - busy_s over that wall. It
    fails if the profiler kept more device time than the spans hold (a
    device operation outside every span). ``post_s`` is the profiler's
    own time after the run."""
    from torch.profiler import ProfilerActivity, profile
    with contextlib.ExitStack() as es:
        prof = es.enter_context(profile(activities=[ProfilerActivity.CPU,
                                                    ProfilerActivity.CUDA]))
        busy = es.enter_context(device_spans()) if spans else None
        _, s = wall(fn)
        t_end = time.perf_counter()
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies): the host ops that
        # launched them report the same device time again
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us:
            rows.append((e.key, us / 1e3))
    rows.sort(key=lambda r: -r[1])
    dev_s = sum(ms for _, ms in rows) / 1e3
    evs = prof.events()
    enqueued = sum("CPU" in str(e.device_type) and bool(ENQUEUE_CALL.match(
        e.name)) for e in evs)
    kept = sum("CUDA" in str(e.device_type) for e in evs)
    base = plain_wall_s or s
    out = {"wall_s": s, "plain_wall_s": plain_wall_s, "device_s": dev_s,
           "idle_share": 1 - dev_s / base if base > 0 else None,
           "enqueued": enqueued, "device_events": kept,
           "complete": kept >= enqueued, "top_ms": rows[:8]}
    if busy is not None:
        out.update(busy, busy_idle_share=1 - busy["busy_s"] / base)
        check(busy["spans"] > 0 and busy["busy_s"] >= 0.99 * dev_s,
              f"device spans hold less than the profiler kept: {out}")
    out["post_s"] = time.perf_counter() - t_end
    return out


# ---------------------------------------------------------------------------
# synthetic UniProtKB/Swiss-Prot releases
# ---------------------------------------------------------------------------

def make_releases(n0: int, n_releases: int, seed: int) -> list[dict]:
    """Full releases: ``ids`` ascending entry numbers (key P%08d), and a
    table aligned with them. Each release after the first drops 0.1% of
    the entries at random, redraws the sequence of 3% of the rest, redraws
    every annotation, and appends 1% new entries."""
    rng = np.random.default_rng(seed)
    ids = np.arange(n0, dtype=np.int64)
    table = {
        "sequence": rng.integers(0, 25, (n0, SEQ_W), dtype=np.int32),
        "length": rng.integers(50, 400, (n0, 1), dtype=np.int32),
        "annotation": rng.integers(0, 100, (n0, ANN_W), dtype=np.int32),
    }
    out = [{"ts": RELEASE_TS[0], "ids": ids, "table": table}]
    next_id = n0
    for ts in RELEASE_TS[1:n_releases]:
        n = len(ids)
        keep = np.ones(n, bool)
        keep[rng.choice(n, int(DEL_FRAC * n), replace=False)] = False
        ids = ids[keep]
        table = {k: v[keep].copy() for k, v in table.items()}
        m = len(ids)
        upd = rng.choice(m, int(SEQ_CHURN * m), replace=False)
        table["sequence"][upd] = rng.integers(0, 25, (len(upd), SEQ_W),
                                              dtype=np.int32)
        table["annotation"] = rng.integers(0, 100, (m, ANN_W), dtype=np.int32)
        n_new = int(NEW_FRAC * n)
        ids = np.concatenate([ids, np.arange(next_id, next_id + n_new)])
        next_id += n_new
        table = {
            "sequence": np.concatenate([table["sequence"], rng.integers(
                0, 25, (n_new, SEQ_W), dtype=np.int32)]),
            "length": np.concatenate([table["length"], rng.integers(
                50, 400, (n_new, 1), dtype=np.int32)]),
            "annotation": np.concatenate([table["annotation"], rng.integers(
                0, 100, (n_new, ANN_W), dtype=np.int32)]),
        }
        out.append({"ts": ts, "ids": ids, "table": table})
    return out


def keys_of(ids: np.ndarray) -> list[bytes]:
    return [b"P%08d" % i for i in ids.tolist()]


def ids_of(keys: list[bytes]) -> np.ndarray:
    """Entry numbers of ``P%08d`` keys, parsed without a Python loop."""
    if not keys:
        return np.zeros(0, np.int64)
    digits = np.frombuffer(b"".join(keys), np.uint8).reshape(len(keys), 9)
    return (digits[:, 1:].astype(np.int64) - 48) @ (10 ** np.arange(7, -1, -1))


def release_at(releases, t):
    """The newest release with ts <= t, or None."""
    live = [r for r in releases if r["ts"] <= t]
    return live[-1] if live else None


def check_view(view, releases, t, fields) -> None:
    """Every row of a materialized version equals the release it came
    from: same keys in row order, same values."""
    rel = release_at(releases, t)
    want_ids = np.zeros(0, np.int64) if rel is None else rel["ids"]
    check(view.ts == t, f"view ts {view.ts} != {t}")
    check(np.array_equal(ids_of(view.keys), want_ids),
          f"version {t}: keys differ from the release")
    for f in fields:
        got = view.values[f]
        want = (np.zeros((0, got.shape[1]), got.dtype) if rel is None
                else rel["table"][f])
        check(got.dtype == want.dtype and np.array_equal(got, want),
              f"version {t}: field {f} differs from the release")


def check_increment(inc, r0, r1) -> None:
    """new / updated / deleted sets of one window against its releases
    (significant field: sequence), values at t1, zeros for deleted."""
    ids0, ids1 = r0["ids"], r1["ids"]
    in1 = np.isin(ids0, ids1)
    new_ids = ids1[~np.isin(ids1, ids0)]
    del_ids = ids0[~in1]
    both = ids0[in1]
    i0 = np.searchsorted(ids0, both)
    i1 = np.searchsorted(ids1, both)
    seq_changed = (r0["table"]["sequence"][i0]
                   != r1["table"]["sequence"][i1]).any(axis=1)
    upd_ids = both[seq_changed]
    got = ids_of(inc.keys)
    want = np.sort(np.concatenate([new_ids, upd_ids, del_ids]))
    check(np.array_equal(got, want),
          f"increment ({inc.t0}, {inc.t1}]: entry set differs")
    kind = np.full(len(want), -1, np.int8)
    kind[np.isin(want, new_ids)] = 0
    kind[np.isin(want, upd_ids)] = 1
    kind[np.isin(want, del_ids)] = 2
    check(np.array_equal(inc.kind, kind),
          f"increment ({inc.t0}, {inc.t1}]: kinds differ")
    alive = kind != 2
    rows = np.searchsorted(ids1, got[alive])
    for f, vals in inc.values.items():
        check(np.array_equal(vals[alive], r1["table"][f][rows]),
              f"increment ({inc.t0}, {inc.t1}]: {f} values differ")
        check(not vals[~alive].any(),
              f"increment ({inc.t0}, {inc.t1}]: deleted rows not zero")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def reset_counts(kops) -> None:
    """Set every kernel's launch count, and its count by kind, to 0."""
    for fn in kops.KERNELS.values():
        fn.launches = 0
        if hasattr(fn, "by_design"):
            fn.by_design.update(dict.fromkeys(fn.by_design, 0))


def read_counts(kops) -> dict:
    """Launches per kernel since the last reset, with ``masked_cumsum_q1``
    the scan's single-query launches."""
    out = {k: fn.launches for k, fn in kops.KERNELS.items()}
    out["masked_cumsum_q1"] = (
        kops.batched_masked_cumsum.by_design["single_query"])
    return out


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_label(mangled: str) -> str:
    """``flash_wgmma_f32_kernel<128>`` from a flash kernel's mangled name
    (the name itself where it does not parse); ``flash_mma_kernel<32,lse>``
    for the mma forward's instantiation that writes the lse;
    ``ssm_scan_kernel<16,bf16>`` (N, x's dtype) and ``wkv_kernel<64>``
    (Dk) for the scan kernels."""
    m = re.search(r"\d((?:ssm_scan|wkv)_kernel)I(.*?)EE", mangled)
    if m:  # ssm_scan_kernel<16,bf16>, wkv_kernel<64>
        args = re.findall(r"Li(\d+)", m.group(2))
        if m.group(1) == "ssm_scan_kernel":
            args += ["bf16" if "bfloat16" in m.group(2) else "float"]
        return f"{m.group(1)}<{','.join(args)}>"
    m = re.search(r"\d(flash\w*?_kernel)I(.*?)EEEv", mangled)
    if not m:
        return mangled
    args = (["float"] if m.group(2).startswith("f") else
            ["bf16"] if "bfloat16" in m.group(2) else [])
    args += re.findall(r"Li(\d+)", m.group(2))
    args += ["lse"] if "Lb1" in m.group(2) else []
    return f"{m.group(1)}<{','.join(args)}>"


def ptxas_by_kernel(log: str) -> dict:
    """Registers and spill bytes of each kernel in a ``ptxas -v`` report,
    by :func:`kernel_label`."""
    out, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = out.setdefault(kernel_label(m.group(1)), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and fn is not None:
            fn.update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn is not None:
            fn["registers"] = int(m[1])
    return out


def phase_env(build_info: dict, smi: str) -> None:
    """The card, the toolchain and the kernels' build: ptxas's registers
    and spills per kernel; for flash attention its whole report (shared
    memory, setmaxnreg, wgmma warnings), registers and spills per kernel,
    and the count of tensor-core product instructions in its SASS, in
    all and per kernel and variant, where cuobjdump exists: HGMMA (BF16,
    TF32) in each wgmma kernel, the f32 ones with TF32 products, and HMMA
    (mma.sync) in flash_mma_kernel (BF16) and flash_mma_f32_kernel
    (TF32), which must not spill; for the flash backward its registers
    and spills and its HGMMA per kernel: BF16 in
    flash_bwd_dkdv_wgmma_kernel and flash_bwd_dq_wgmma_kernel at D 64, 112
    and 128, neither spilling at D 64, and TF32 in
    flash_bwd_dkdv_wgmma_f32_kernel and flash_bwd_dq_wgmma_f32_kernel at D
    64, 112 and 128, none spilling; and its HMMA per kernel (mma.sync):
    BF16 in flash_bwd_dkdv_mma_kernel and flash_bwd_dq_mma_kernel at D 8,
    16 and 32 in bf16, TF32 in their f32 instantiations; the scan kernels'
    registers and spills per instantiation (ssm_scan_kernel at N 8 and 16,
    x f32 and bf16; wkv_kernel at Dk 16 and 64), none of which may
    spill."""
    from repro_torch.kernels import _build
    ptxas = build_info["ptxas"]
    by_fn = _build.sass_opcodes_by_function("flash_attention", "HGMMA")
    by_kernel = (None if by_fn is None else
                 {kernel_label(k): v for k, v in sorted(by_fn.items())})
    mma_fn = _build.sass_opcodes_by_function("flash_attention", "HMMA")
    mma_by_kernel = (None if mma_fn is None else
                     {kernel_label(k): v for k, v in sorted(mma_fn.items())})
    flash_regs = ptxas_by_kernel(ptxas.get("flash_attention", ""))
    bwd_fn = _build.sass_opcodes_by_function("flash_attention_bwd", "HGMMA")
    bwd_hgmma = (None if bwd_fn is None else
                 {kernel_label(k): v for k, v in sorted(bwd_fn.items())})
    bwd_regs = ptxas_by_kernel(ptxas.get("flash_attention_bwd", ""))
    scan_regs = {k: v for src in ("ssm_scan", "wkv")
                 for k, v in ptxas_by_kernel(ptxas.get(src, "")).items()}
    bwd_mma_fn = _build.sass_opcodes_by_function("flash_attention_bwd",
                                                 "HMMA")
    bwd_hmma = (None if bwd_mma_fn is None else
                {kernel_label(k): v for k, v in sorted(bwd_mma_fn.items())})
    emit({"phase": "env", "gpu": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "build_seconds": build_info["seconds"],
          "built": build_info["built"],
          "ptxas": {k: [ln.strip() for ln in v.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in ptxas.items()},
          "flash_ptxas": [ln.strip() for ln in ptxas.get(
              "flash_attention", "").splitlines() if ln.strip()],
          "flash_hgmma": (None if by_fn is None else
                          sum(sum(v.values()) for v in by_fn.values())),
          "flash_hgmma_by_kernel": by_kernel,
          "flash_hmma_by_kernel": mma_by_kernel,
          "flash_registers_by_kernel": flash_regs,
          "flash_bwd_hgmma_by_kernel": bwd_hgmma,
          "flash_bwd_hmma_by_kernel": bwd_hmma,
          "flash_bwd_registers_by_kernel": bwd_regs,
          "scan_registers_by_kernel": scan_regs})
    for src, names in (("ssm_scan", [f"ssm_scan_kernel<{n},{x}>"
                                     for n in (8, 16)
                                     for x in ("float", "bf16")]),
                       ("wkv", [f"wkv_kernel<{d}>" for d in (16, 64)])):
        for name in names:
            if src in ptxas:
                got = scan_regs.get(name, {})
                check(got.get("spill_stores") == 0
                      and got.get("spill_loads") == 0,
                      f"{name}: spills or no ptxas report: {got}")
    # the serving instantiations and the training ones (the lse written)
    for name, variant in [(f"flash_mma_kernel<{d}{x}>", "HMMA.16816.F32.BF16")
                          for d in (8, 16, 32) for x in ("", ",lse")] + [
                              (f"flash_mma_f32_kernel<{d}{x}>",
                               "HMMA.1688.F32.TF32") for d in (8, 16, 32)
                              for x in ("", ",lse")]:
        if "flash_attention" in ptxas:
            got = flash_regs.get(name, {})
            check(got.get("spill_stores") == 0 and got.get("spill_loads") == 0,
                  f"{name}: spills or no ptxas report: {got}")
        if mma_by_kernel is not None:
            check(mma_by_kernel.get(name, {}).get(variant, 0) > 0,
                  f"{name}: no {variant} in its SASS")
    if by_kernel is not None:
        for name, variant in [(f"flash_wgmma_kernel<{d}>", "HGMMA.F32.BF16")
                              for d in (64, 112, 128)] + [
                                  (f"flash_wgmma_f32_kernel<{d}>",
                                   "HGMMA.F32.TF32") for d in (64, 112, 128)]:
            check(by_kernel.get(name, {}).get(variant, 0) > 0,
                  f"{name}: no {variant} instruction in its SASS")
    # the backward's tensor-core kernels: bf16 products in the wgmma ones,
    # TF32 in the f32 ones; no spill in the f32 ones, nor at D 64 in bf16;
    # the mma ones' mma.sync products, BF16 and TF32
    for d in (8, 16, 32):
        for kern in ("flash_bwd_dkdv_mma_kernel", "flash_bwd_dq_mma_kernel"):
            for t, variant in (("bf16", "HMMA.16816.F32.BF16"),
                               ("float", "HMMA.1688.F32.TF32")):
                name = f"{kern}<{t},{d}>"
                if bwd_hmma is not None:
                    check(bwd_hmma.get(name, {}).get(variant, 0) > 0,
                          f"{name}: no {variant} in its SASS")
    for d in (64, 112, 128):
        for kern, variant in (("flash_bwd_dkdv_wgmma_kernel", "BF16"),
                              ("flash_bwd_dq_wgmma_kernel", "BF16"),
                              ("flash_bwd_dkdv_wgmma_f32_kernel", "TF32"),
                              ("flash_bwd_dq_wgmma_f32_kernel", "TF32")):
            name = f"{kern}<{d}>"
            if ((d == 64 or variant == "TF32")
                    and "flash_attention_bwd" in ptxas):
                got = bwd_regs.get(name, {})
                check(got.get("spill_stores") == 0
                      and got.get("spill_loads") == 0,
                      f"{name}: spills or no ptxas report: {got}")
            if bwd_hgmma is not None:
                check(bwd_hgmma.get(name, {}).get(f"HGMMA.F32.{variant}", 0)
                      > 0, f"{name}: no HGMMA.F32.{variant} in its SASS")


def sdpa_lower_right(qt, kt, vt):
    """SDPA on (B, H, S, D) tensors with the kernels' causal mask at
    Sq < Sk, the queries aligned to the end of the key axis
    (``causal_lower_right``: SDPA's ``is_causal`` aligns them to its
    start); k and v with every query head's copy."""
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right
    return F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=causal_lower_right(qt.shape[2], kt.shape[2]))


class KernelBench:
    """Runs each kernel against its plain version and keeps the record of
    the main-path shape for the ``kernels`` line."""

    def __init__(self, kops, roofline, smi: str, reps: int):
        self.kops, self.roof, self.smi, self.reps = kops, roofline, smi, reps
        self.main: dict[str, dict] = {}

    def bound(self, nbytes: float, ops: float,
              peak: float | None = None) -> tuple[float, str]:
        tb = nbytes / self.roof.HBM_BW
        to = ops / (peak or self.roof.PEAK_CUDA_CORE_OPS)
        return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")

    def run(self, name: str, shape: dict, kernel, plain, nbytes, ops,
            library=None, *, timed: bool, main: bool = False,
            quiet: bool = False, tol: tuple | None = None,
            peak: float | None = None, reps: int | None = None,
            rounds: int = 1, extra: dict | None = None,
            device: bool = False) -> dict:
        """``tol`` (atol, rtol): compare values within it instead of bits;
        ``peak``: the compute rate of the bound (default: CUDA cores);
        ``rounds``: time kernel and library in that many alternating
        rounds, report the medians, keep every round and count those the
        kernel won; ``extra``: more keys for the record; ``device``: also
        time the kernel's calls queued behind a spin kernel
        (``device_ms``: the card's time per call, with no host time in it,
        for kernels whose calls take longer on the host than on the card).
        Both outputs are freed before the timing (a Q = 64 gather's are 9
        GB each)."""
        got = kernel()
        want = plain()
        sync()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err, ok = 0, True
        for g, w in zip(got, want):
            check(g.shape == w.shape and g.dtype == w.dtype,
                  f"{name} {shape}: {g.shape} {g.dtype} vs {w.shape} {w.dtype}")
            if tol is not None:
                d = (g.float() - w.float()).abs()
                if d.numel():
                    err = max(err, float(d.max()))
                    ok &= bool((d <= tol[0] + tol[1] * w.float().abs())
                               .all())
                continue
            # compare bits: floats (the codec's XOR deltas, NaN included)
            # as the int lanes of their width
            if g.is_floating_point():
                g, w = int_lanes(g), int_lanes(w)
            if g.numel() and not torch.equal(g, w):
                err = max(err, max_abs_diff(g, w), 1)
                ok = False
        del got, want, g, w
        bound_ms, bound_by = self.bound(nbytes, ops, peak)
        rec = {"phase": "kernel", "name": name, "shape": shape,
               "max_abs_diff": err, "bound_ms": bound_ms,
               "bound_by": bound_by, "replaces": SOURCES[name][1],
               "gpu": self.smi}
        if tol is not None:
            rec["tol"] = {"atol": tol[0], "rtol": tol[1]}
        if timed:
            n = reps or self.reps
            ks, ls = [], []
            for _ in range(rounds):
                ks.append(cuda_ms(kernel, n))
                if library is not None:
                    ls.append(cuda_ms(library, n))
            rec["kernel_ms"] = float(np.median(ks))
            rec["plain_ms"] = cuda_ms(plain, n)
            rec["library_ms"] = float(np.median(ls)) if ls else None
            rec["reps"] = n
            if device:
                rec["device_ms"] = queued_ms(kernel, n)
            if rounds > 1:
                rec["rounds"] = {"kernel_ms": ks, "library_ms": ls}
                if ls:
                    rec["rounds_won"] = sum(k < lib for k, lib in zip(ks, ls))
        rec.update(extra or {})
        if not quiet:
            emit(rec)
        check(ok, f"{name} {shape}: kernel differs from plain by {err}")
        if main:
            self.main[name] = rec
        return rec

    # -- the three kernels --------------------------------------------------
    def fingerprint(self, lanes, *, timed=True, main=False,
                    quiet=False, name="fingerprint") -> dict:
        """The fingerprint bit for bit, with the kernel's plan in the
        shape, and its device time alone where timed; ``name``: its row
        in the kernels line."""
        from repro_torch.kernels.fingerprint import fingerprint_plan
        n, w = lanes.shape
        align = lanes.data_ptr() % 16
        plan = fingerprint_plan(w, align)
        return self.run(
            name, {"N": n, "W": w, "base_align": align,
                            "path": plan.path,
                            "rows_per_tile": plan.rows_per_tile,
                            "stages": plan.stages, "threads": plan.threads,
                            "lanes_per_chunk": plan.lanes_per_chunk},
            lambda: self.kops.fingerprint(lanes),
            lambda: self.kops.ref.ref_fingerprint(lanes),
            nbytes=n * w * 4 + n * 8, ops=5 * n * w + 4 * n,
            timed=timed, main=main, quiet=quiet, device=True)

    def masked_cumsum(self, ts, tq, *, timed=True, main=False,
                      quiet=False, rounds=1) -> dict:
        """The scan. Q = 1 records as ``masked_cumsum_q1``."""
        (c,), (q,) = ts.shape, tq.shape
        mask = (ts[None, :] <= tq[:, None]).to(torch.int32)
        return self.run(
            "masked_cumsum_q1" if q == 1 else "masked_cumsum",
            {"C": c, "Q": q},
            lambda: self.kops.batched_masked_cumsum(ts, tq),
            lambda: self.kops.ref.ref_batched_masked_cumsum(ts, tq),
            nbytes=c * 4 + q * 4 + q * c * 4, ops=2 * q * c,
            library=lambda: torch.cumsum(mask, dim=1, dtype=torch.int32),
            timed=timed, main=main, quiet=quiet, rounds=rounds)

    def stacked_masked_cumsum(self, ts, tq, *, timed=True, main=False,
                              quiet=False) -> dict:
        (s, c), (q,) = ts.shape, tq.shape
        mask = (ts[:, None, :] <= tq[None, :, None]).to(torch.int32)
        return self.run(
            "stacked_masked_cumsum", {"S": s, "C": c, "Q": q},
            lambda: self.kops.stacked_masked_cumsum(ts, tq),
            lambda: self.kops.ref.ref_stacked_masked_cumsum(ts, tq),
            nbytes=s * c * 4 + q * 4 + s * q * c * 4, ops=2 * s * q * c,
            library=lambda: torch.cumsum(mask, dim=2, dtype=torch.int32),
            timed=timed, main=main, quiet=quiet)

    def shard_route(self, lanes, lens, n_shards, *, timed=True, main=False,
                    quiet=False) -> dict:
        n, w = lanes.shape
        return self.run(
            "shard_route", {"N": n, "W": w, "shards": n_shards},
            lambda: self.kops.shard_route(lanes, lens, n_shards),
            lambda: self.kops.ref.ref_shard_route(lanes, lens, n_shards),
            nbytes=n * w * 4 + 2 * n * 4, ops=n * (8 * w + 5),
            timed=timed, main=main, quiet=quiet, device=True)

    def shard_route_bytes(self, flat, offsets, n_shards, *, timed=True,
                          main=False, quiet=False) -> dict:
        """The route from flat key bytes against its plain version. Its
        bound: the key bytes, the offsets and the ids moved once, and the
        fold of each key's ceil(len / 4) lanes."""
        n = offsets.shape[0] - 1
        lanes = int(((offsets[1:] - offsets[:-1] + 3) // 4).sum())
        tile = self.kops.launch.tile_for("shard_route", n=n,
                                         device=flat.device)
        return self.run(
            "shard_route_bytes", {"N": n, "bytes": flat.shape[0],
                                  "lanes": lanes, "shards": n_shards,
                                  "base_align": flat.data_ptr() % 16,
                                  "tile": tile},
            lambda: self.kops.shard_route_bytes(flat, offsets, n_shards),
            lambda: self.kops.ref.ref_shard_route_bytes(flat, offsets,
                                                        n_shards),
            nbytes=flat.shape[0] + 8 * (n + 1) + 4 * n, ops=8 * lanes + 5 * n,
            timed=timed, main=main, quiet=quiet, device=True)

    def codec(self, name, a, b, *, unsigned=False, timed=True, main=False,
              label=None, quiet=False, rounds=1) -> dict:
        """One delta-codec wrapper on the pair (a, b): bits and per-tile
        stats against the plain version (``ref``) on the same card.
        ``rounds``: as for :meth:`run`."""
        kops, ref = self.kops, self.kops.ref
        n, w = a.shape
        tile = kops.launch.tile_for("delta_codec", n=n, device=a.device)
        fl = a.is_floating_point()
        op = {"delta_pack": "xor" if fl else "sub",
              "delta_unpack": "xor" if fl else "add",
              "delta_pack_wide": "xor" if fl else "sub",
              "delta_unpack_wide": "xor" if fl else "add"}[name]
        fn = getattr(kops, name)
        if name == "delta_pack":
            kernel = lambda: fn(a, b, unsigned=unsigned)  # noqa: E731

            def plain():
                d = ref.ref_codec(a, b, op)
                return d, ref.ref_tile_stat(d, tile, "nonzero" if fl
                                            else "maxabs", unsigned=unsigned)
        else:
            kernel = lambda: fn(a, b)  # noqa: E731
            plain = lambda: ref.ref_codec(a, b, op)  # noqa: E731
        if fl:
            x, y = int_lanes(a), int_lanes(b)
            library = lambda: torch.bitwise_xor(x, y)  # noqa: E731
        else:
            library = {"sub": lambda: torch.sub(a, b),
                       "add": lambda: torch.add(a, b)}[op]
        n_tiles = -(-n // tile)
        return self.run(
            name, {"N": n, "W": w, "dtype": label or str(a.dtype)}, kernel,
            plain, nbytes=3 * a.numel() * a.element_size() + 4 * n_tiles,
            ops=(2 if name == "delta_pack" else 1) * a.numel(),
            library=library, timed=timed, main=main, quiet=quiet,
            rounds=rounds)

    def masked_merge(self, base, upd, rm, fm, ts, ts_new, *, timed=True,
                     main=False, quiet=False, rounds=1) -> dict:
        """The merge bit for bit against its plain version, with the
        kernel's plan in the shape. Its bound counts the bytes these masks
        need (``merge_nbytes``: one operand element per output element,
        the timestamps only of the rows that keep theirs); the count with
        both operands read stays beside it as ``bound_both_operands_ms``,
        the bound of a kernel that reads both."""
        from repro_torch.kernels import masked_merge as mm
        n, w = base.shape
        sel = rm[:, None] & fm[None, :]
        ts_new_t = torch.tensor(ts_new, dtype=ts.dtype, device=ts.device)
        plan = mm.merge_plan(base, upd)
        nb = mm.merge_nbytes(rm, fm, base.element_size(), ts.element_size())
        return self.run(
            "masked_merge", {"N": n, "W": w, "dtype": str(base.dtype),
                             "ts": str(ts.dtype),
                             "rows_merged": int(rm.sum()),
                             "fields_taken": int(fm.sum()),
                             "vec_bytes": plan.vec_bytes,
                             "rows_per_block": plan.rows_per_block},
            lambda: self.kops.masked_merge(base, upd, rm, fm, ts, ts_new),
            lambda: self.kops.ref.ref_masked_merge(base, upd, rm, fm, ts,
                                                   ts_new),
            nbytes=nb["mask_aware"], ops=n * w + n,
            library=lambda: (torch.where(sel, upd, base),
                             torch.where(rm, ts_new_t, ts)),
            timed=timed, main=main, quiet=quiet, rounds=rounds,
            extra={"bound_both_operands_ms": self.bound(
                nb["both_operands"], n * w + n)[0]})

    def flash(self, q, k, v, *, timed=True, main=False, quiet=False,
              reps=None, name="flash_attention", rounds=1,
              device=False, lse=False, lower_right=False) -> dict:
        """Flash attention against its plain version within FLASH_TOL,
        bound by its causal FLOPs at the dtype's peak (f32: three TF32
        products each, ``roofline.compute_peak``), with the design the
        wrapper takes (``shape["design"]``); the library yardstick (SDPA)
        at Sq == Sk, since its ``is_causal`` mask is top-left aligned,
        and with ``lower_right`` at Sq < Sk in bf16 too, masked by
        ``causal_lower_right`` (sdpa_lower_right). SDPA
        takes GQA itself in bf16; in f32 its memory-efficient kernel,
        which does not, gets k and v repeated over the query heads (made
        before the timing), since its math fallback would hold the full
        logits. ``lse``: the kernel also writes the log-sum-exp, as
        training's forward does (``shape["lse"]``)."""
        import torch.nn.functional as F
        from torch.nn.attention import SDPBackend, sdpa_kernel
        from repro_torch.kernels import flash_attention as fa
        b, sq, h, d = q.shape
        sk, kh = k.shape[1], k.shape[2]
        library = None
        if sq == sk and q.dtype == torch.bfloat16:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=True, enable_gqa=True)
        elif sq == sk:
            qt, kt, vt = (x.transpose(1, 2) for x in (
                q, k.repeat_interleave(h // kh, 2),
                v.repeat_interleave(h // kh, 2)))

            def library():
                with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                    return F.scaled_dot_product_attention(qt, kt, vt,
                                                          is_causal=True)
        elif lower_right and q.dtype == torch.bfloat16:
            qt, kt, vt = (x.transpose(1, 2) for x in (
                q, k.repeat_interleave(h // kh, 2),
                v.repeat_interleave(h // kh, 2)))
            library = lambda: sdpa_lower_right(qt, kt, vt)  # noqa: E731
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        return self.run(
            name, {"B": b, "Sq": sq, "Sk": sk, "H": h, "K": kh, "D": d,
                   "dtype": str(q.dtype), "design": fa.design(q.dtype, d),
                   "copies": list(fa.plan(q, k, v).copies), "lse": lse},
            ((lambda: fa._forward(q, k, v, lse=True)[0]) if lse
             else lambda: self.kops.flash_attention(q, k, v)),
            lambda: self.kops.ref.ref_flash_attention(
                q, k, v, bq=PLAIN_FLASH_TILE, bk=PLAIN_FLASH_TILE),
            nbytes=nbytes, ops=4 * b * h * d * fa.causal_pairs(sq, sk),
            library=library, timed=timed, main=main, quiet=quiet,
            tol=FLASH_TOL[q.dtype],
            peak=self.roof.compute_peak(str(q.dtype).split(".")[-1]),
            reps=reps, rounds=rounds, device=device)

    def flash_bwd(self, q, k, v, o, lse, do, *, suffix: str = "",
                  reps: int = 3, scaled: bool = False) -> None:
        """The three backward kernels on the forward's o and lse, each
        against the plain backward (``ref_flash_attention_bwd``, which
        computes all three gradients: its time is the whole plain
        backward's) within BWD_TOL, with their device time alone; the
        design (bf16: wgmma, f32: wgmma_f32) is in
        ``shape["plan"]["design"]``. Bounds:
        delta by its bytes; dkdv by its four products over the visible
        pairs (S recomputed, dP, dV, dK) and dq by its three (S, dP, dQ),
        2 B H D FLOPs a pair each, at the dtype's tensor-core peak. The
        library yardstick of dkdv and dq is SDPA's backward
        (``torch.autograd.grad`` of ``scaled_dot_product_attention`` with
        ``is_causal`` and ``enable_gqa``; in f32 its memory-efficient
        kernel with k and v repeated over the heads), which computes all
        three gradients; at Sq < Sk masked by ``causal_lower_right`` on k
        and v repeated over the heads (sdpa_lower_right). Both designs
        (bf16: wgmma, f32: wgmma_f32) are on the tensor cores. Each row
        gives the plain values' largest magnitude (``want_max``); with
        ``scaled`` (a seeded dO) each must be at least 100 times
        BWD_TOL's atol, so that the atol cannot pass an output of
        zeros."""
        import torch.nn.functional as F
        from torch.nn.attention import SDPBackend, sdpa_kernel
        from repro_torch.kernels import flash_attention as fa
        kops, ref = self.kops, self.kops.ref
        b, sq, h, d = q.shape
        sk, kh = k.shape[1], k.shape[2]
        es = q.element_size()
        pairs = fa.causal_pairs(sq, sk)
        product = 2 * b * h * d * pairs
        peak = self.roof.compute_peak(str(q.dtype).split(".")[-1])
        shape = {"B": b, "Sq": sq, "Sk": sk, "H": h, "K": kh, "D": d,
                 "dtype": str(q.dtype),
                 "plan": dataclasses.asdict(fa.bwd_plan(q, k, v, do)) | {
                     "first_q_tile": None, "dq_trips": None, "maps": None}}
        delta = kops.flash_bwd_delta(o, do)
        if q.dtype == torch.bfloat16:
            ctx = contextlib.nullcontext
            kr, vr = k, v
        else:
            ctx = lambda: sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION)  # noqa
            kr, vr = (x.repeat_interleave(h // kh, 2) for x in (k, v))
        if sq != sk and q.dtype == torch.bfloat16:
            kr, vr = (x.repeat_interleave(h // kh, 2) for x in (k, v))
        qt, kt, vt = (x.detach().transpose(1, 2).contiguous()
                      .requires_grad_() for x in (q, kr, vr))
        with ctx():
            out = (sdpa_lower_right(qt, kt, vt) if sq != sk else
                   F.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True,
                       enable_gqa=q.dtype == torch.bfloat16))
        dot = do.transpose(1, 2).contiguous()

        def library():
            with ctx():
                return torch.autograd.grad(out, (qt, kt, vt), dot,
                                           retain_graph=True)

        def plain():
            return ref.ref_flash_attention_bwd(
                q, k, v, o, lse, do, bq=PLAIN_FLASH_TILE,
                bk=PLAIN_FLASH_TILE)

        lse_bytes = 2 * lse.numel() * 4  # lse and delta
        mags = dict(zip(("delta", "dq", "dk", "dv"), (
            float(x.float().abs().max()) if x.numel() else 0.0
            for x in (ref.ref_flash_bwd_delta(o, do), *plain()))))
        if scaled:
            check(all(m >= 100 * BWD_TOL[torch.float32][0]
                      for m in mags.values()),
                  f"flash_bwd{suffix}: plain values too small for BWD_TOL's "
                  f"atol: {mags}")
        self.run("flash_bwd_delta" + suffix, shape,
                 lambda: kops.flash_bwd_delta(o, do),
                 lambda: ref.ref_flash_bwd_delta(o, do),
                 nbytes=2 * o.numel() * es + lse.numel() * 4,
                 ops=2 * o.numel(), tol=BWD_TOL[torch.float32], main=True,
                 timed=True, reps=reps, device=True,
                 extra={"want_max": mags["delta"]})
        self.run("flash_bwd_dkdv" + suffix, shape,
                 lambda: kops.flash_bwd_dkdv(q, k, v, do, lse, delta),
                 lambda: plain()[1:],
                 nbytes=(2 * q.numel() + 4 * k.numel()) * es + lse_bytes,
                 ops=4 * product, library=library, peak=peak,
                 tol=BWD_TOL[q.dtype], main=True, timed=True, reps=reps,
                 device=True, extra={"want_max": [mags["dk"], mags["dv"]]})
        self.run("flash_bwd_dq" + suffix, shape,
                 lambda: kops.flash_bwd_dq(q, k, v, do, lse, delta),
                 lambda: plain()[0],
                 nbytes=(3 * q.numel() + 2 * k.numel()) * es + lse_bytes,
                 ops=3 * product, library=library, peak=peak,
                 tol=BWD_TOL[q.dtype], main=True, timed=True, reps=reps,
                 device=True, extra={"want_max": mags["dq"]})
        del out, qt, kt, vt

    def chain_decode(self, deltas, heads, idx, itemsize, *, xor=False,
                     timed=True, main=False, quiet=False, label=None,
                     name="chain_decode") -> dict:
        """The decode-at-index gather against its plain version (the full
        torch-ops decode, the take and the truncation), bit for bit. Its
        bound counts what these inputs need: every cell on a taken cell's
        chain prefix once (W packed lanes and a head byte each), however
        many taken cells share it, and each taken cell's index and W
        output lanes. No single PyTorch call computes a segmented scan,
        so it has no library time."""
        from repro_torch.kernels import delta_codec as dc
        c, w = deltas.shape
        n = idx.shape[0]
        covered = covered_cells(heads.cpu().numpy(), idx.cpu().numpy())
        s_in = deltas.element_size()
        plan = dc.decode_at_plan(deltas)
        return self.run(
            name, {"C": c, "W": w, "n": n, "packed": str(deltas.dtype),
                   "itemsize": itemsize, "xor": xor,
                   "covered_cells": covered, "vec_bytes": plan.vec_bytes,
                   "threads_per_cell": plan.threads_per_cell,
                   **({"label": label} if label else {})},
            lambda: self.kops.chain_decode_at(deltas, heads, idx,
                                              itemsize=itemsize, xor=xor),
            lambda: self.kops.ref_chain_decode_at(deltas, heads, idx,
                                                  itemsize=itemsize,
                                                  xor=xor),
            nbytes=covered * (w * s_in + 1) + n * idx.element_size()
            + n * w * itemsize, ops=covered * w + n * w,
            timed=timed, main=main, quiet=quiet)

    def keep_mask(self, ts, cutoff, *, timed=True, main=False,
                  quiet=False) -> dict:
        """The keep mask and its per-tile counts at the tile it resolves
        (``shape["tile"]``: cells per block), bit for bit."""
        (c,) = ts.shape
        tile = self.kops.launch.tile_for("compact_rewrite", n=c,
                                         device=ts.device)
        n_tiles = -(-c // tile)
        return self.run(
            "keep_mask", {"C": c, "cutoff": cutoff, "tile": tile},
            lambda: self.kops.keep_mask(ts, cutoff),
            lambda: self.kops.ref.ref_keep_mask(ts, cutoff, tile),
            nbytes=8 * c + 4 * n_tiles, ops=2 * c,
            timed=timed, main=main, quiet=quiet, device=True)

    def ssm_scan(self, dt, bmat, cmat, x, a, h0, *, chunked=True,
                 timed=False, main=False, quiet=False, tol=SCAN_TOL,
                 reps=None, extra=None, label=None) -> dict:
        """The selective scan against its plain version (the chunked torch
        ops, or at ``chunked=False`` the sequential recurrence) within
        ``tol``. Its bound: dt, x, B, C, A and h0 read once, y and h_L
        written once, against one exponential and 7 other f32 operations
        an element of (B, L, d_inner, N), the exponentials split between
        the special-function units and the FMA pipe (``exp_bound_s``);
        beside it the exponentials on the units alone
        (``bound_ex2_sfu_ms``), the other f32 work alone
        (``bound_fp32_ms``) and the bytes (``bound_bytes_ms``). No single
        PyTorch call computes a scan: no library time."""
        from repro_torch.kernels import ref
        b, l, di = dt.shape
        n = a.shape[1]
        plain = ref.ssm_scan_chunked if chunked else ref.ssm_scan_sequential
        elems = b * l * di * n
        nbytes = (4 * (dt.numel() + bmat.numel() + cmat.numel() + a.numel()
                       + 2 * h0.numel() + b * l * di)
                  + x.numel() * x.element_size())
        return self.run(
            "ssm_scan", {"B": b, "L": l, "d_inner": di, "N": n,
                         "x": str(x.dtype), "chunked": chunked,
                         "b_strides": list(bmat.stride()),
                         **({"case": label} if label else {})},
            lambda: self.kops.ssm_scan(dt, bmat, cmat, x, a, h0,
                                       chunked=chunked),
            lambda: plain(dt, bmat, cmat, x, a, h0),
            nbytes=nbytes, ops=elems, peak=elems / exp_bound_s(
                elems, 7 * elems, self.roof.PEAK_CUDA_CORE_OPS), tol=tol,
            timed=timed, main=main, quiet=quiet, reps=reps, device=timed,
            extra={"bound_ex2_sfu_ms": elems / SFU_EX2_PER_S * 1e3,
                   "bound_fp32_ms": 7 * elems
                   / self.roof.PEAK_CUDA_CORE_OPS * 1e3,
                   "bound_bytes_ms": nbytes / self.roof.HBM_BW * 1e3,
                   **(extra or {})})

    def wkv(self, r, k, v, logw, u, s0, *, chunked=True, timed=False,
            main=False, quiet=False, tol=SCAN_TOL, reps=None,
            extra=None, label=None) -> dict:
        """The WKV recurrence against its plain version (chunked, or the
        sequential recurrence) within ``tol``. Its bound: r, k, v, logw,
        u and S_0 read once, o and S_L written once, against 5 f32
        operations an (i, j) of each head's state a step (r S, the
        decay's product and the k v add) at the CUDA cores' rate. No
        library time."""
        from repro_torch.kernels import ref
        b, l, h, dk = r.shape
        plain = ref.wkv_chunked if chunked else ref.wkv_sequential
        return self.run(
            "wkv", {"B": b, "L": l, "H": h, "Dk": dk, "chunked": chunked,
                    **({"case": label} if label else {})},
            lambda: self.kops.wkv(r, k, v, logw, u, s0, chunked=chunked),
            lambda: plain(r, k, v, logw, u, s0),
            nbytes=4 * (5 * r.numel() + u.numel() + 2 * s0.numel()),
            ops=5 * b * l * h * dk * dk, tol=tol, timed=timed, main=main,
            quiet=quiet, reps=reps, device=timed, extra=extra)


def covered_cells(heads: np.ndarray, idx: np.ndarray) -> int:
    """Cells on the chain prefixes of the taken cells ``idx`` (clamped to
    [0, C)), each counted once: a chain's taken cells share its prefix, so
    a chain covers its head through its last taken cell. Cells before the
    first head chain from cell 0."""
    c = len(heads)
    if c == 0 or len(idx) == 0:
        return 0
    head_at = np.maximum.accumulate(np.where(heads, np.arange(c), 0))
    u = np.unique(np.clip(idx.astype(np.int64), 0, c - 1))
    h = head_at[u]
    last = np.append(h[1:] != h[:-1], True)  # the last taken cell a chain
    return int((u[last] - h[last] + 1).sum())


def max_abs_diff(g: torch.Tensor, w: torch.Tensor,
                 chunk: int = 1 << 26) -> float:
    """max |g - w| of two int tensors, in chunks of ``chunk`` elements (no
    full-size difference tensor)."""
    g, w = g.reshape(-1), w.reshape(-1)
    return max(float((g[i:i + chunk].double() - w[i:i + chunk].double())
                     .abs().max()) for i in range(0, g.numel(), chunk))


def int_lanes(t: torch.Tensor) -> torch.Tensor:
    """The signed int lanes of ``t``'s width (bits unchanged)."""
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def codec_pair(rng, dtype: str, n: int, w: int):
    """(new, old, unsigned) device tensors for the codec: random lanes
    with the dtype's extremes (ints) or NaN and +-inf (floats), a third of
    them unchanged. Unsigned dtypes travel as their signed bit view, as
    the store keeps them."""
    dt = np.dtype(dtype)
    if dt.kind in "iu":
        info = np.iinfo(dt)
        new = rng.integers(info.min, info.max, (n, w), endpoint=True, dtype=dt)
        old = rng.integers(info.min, info.max, (n, w), endpoint=True, dtype=dt)
        new.flat[0], old.flat[0] = info.min, info.max
        new.flat[-1], old.flat[-1] = info.max, info.min
        if dt.kind == "i":
            new.flat[new.size // 2], old.flat[new.size // 2] = info.min, 0
        new, old = (x.view(f"i{dt.itemsize}") for x in (new, old))
    else:
        new = rng.normal(scale=100, size=(n, w)).astype(dt)
        old = rng.normal(scale=100, size=(n, w)).astype(dt)
        new.flat[0], old.flat[-1], new.flat[-1] = np.nan, np.inf, -np.inf
    old[::3] = new[::3]
    return (torch.as_tensor(new, device=DEV), torch.as_tensor(old, device=DEV),
            dt.kind == "u")


def phase_kernel_edges_fingerprint(bench: KernelBench, rng) -> None:
    """The fingerprint at every path of its plan (rows, 16-byte and 4-byte
    tiles, rows staged in chunks past 128 lanes), at N 1, 513 and 200,003
    (a ragged last tile, several tiles a block), on bases 0, 4 and 8 bytes
    past a 16-byte boundary (a row slice of a larger buffer), bit for
    bit, summarized in one line with each case's plan."""
    cases = []
    for n in FP_EDGE_N:
        for w in FP_EDGE_W:
            lanes = rng.integers(INT32.min, INT32.max, (n, w),
                                 dtype=np.int32, endpoint=True)
            lanes[0, 0] = INT32.min
            lanes[-1, -1] = INT32.max
            t = torch.as_tensor(lanes, device=DEV)
            for off in FP_EDGE_OFFSETS:
                x = t if off == 0 else at_offset(t, off)
                if off:  # a contiguous row slice with a storage offset
                    check(x.storage_offset() > 0 and x.is_contiguous(),
                          "the offset case is no contiguous view")
                cases.append(bench.fingerprint(x, timed=False, quiet=True))
    shapes = [c["shape"] for c in cases]
    emit({"phase": "kernel_edges_fingerprint", "W": list(FP_EDGE_W),
          "N": list(FP_EDGE_N), "offsets_bytes": list(FP_EDGE_OFFSETS),
          "cases": len(cases),
          "paths": sorted({sh["path"] for sh in shapes}),
          "plans": [[sh[k] for k in ("W", "N", "base_align", "path",
                                     "rows_per_tile", "stages", "threads",
                                     "lanes_per_chunk")] for sh in shapes],
          "max_abs_diff": max(c["max_abs_diff"] for c in cases),
          "gpu": bench.smi})
    check({sh["path"] for sh in shapes} == {"rows", "tile16", "tile4"},
          "the fingerprint edges missed a path of the plan")


def phase_kernel_edges(bench: KernelBench, rng) -> None:
    """Ragged and extreme shapes, compared only (they time launch cost)."""
    dev = DEV
    phase_kernel_edges_fingerprint(bench, rng)
    phase_kernel_edges_scan(bench, rng)
    phase_kernel_edges_decode(bench, rng)
    ts_max = 2**31 - 2
    for c in (1, 1023, 1025, 100_003):
        ts = rng.integers(-100, 100, c).astype(np.int32)
        for cutoff in (0, -(2**31) + 1, ts_max):
            bench.keep_mask(torch.as_tensor(ts, device=dev), cutoff,
                            timed=False)
    # the codec: every lane dtype at ragged N, summarized in one line
    cases = []
    for dtype in CODEC_DTYPES:
        wide = np.dtype(dtype).itemsize == 8
        for n in (1, 511, 513, 70_001):
            for w in (1, 8, 64):
                new, old, uns = codec_pair(rng, dtype, n, w)
                pack, unpack = (("delta_pack_wide", "delta_unpack_wide")
                                if wide else ("delta_pack", "delta_unpack"))
                cases.append(bench.codec(pack, new, old, unsigned=uns,
                                         timed=False, label=dtype,
                                         quiet=True))
                cases.append(bench.codec(unpack, new, old, timed=False,
                                         label=dtype, quiet=True))
    # bases 4 and 8 bytes past a 16-byte boundary (the kernel's scalar
    # head), flat lengths that are no multiple of the 16-byte vector (its
    # tail), and new and old at different offsets (every lane scalar)
    n_aligned = len(cases)
    for dtype in CODEC_DTYPES:
        size = np.dtype(dtype).itemsize
        pack, unpack = (("delta_pack_wide", "delta_unpack_wide")
                        if size == 8 else ("delta_pack", "delta_unpack"))
        for off_new, off_old in ((4, 4), (8, 8), (4, 8)):
            if off_new % size or off_old % size:
                continue
            for n, w in ((1, 7), (513, 3), (1025, 5), (70_001, 9)):
                new, old, uns = codec_pair(rng, dtype, n, w)
                new, old = at_offset(new, off_new), at_offset(old, off_old)
                cases.append(bench.codec(pack, new, old, unsigned=uns,
                                         timed=False, label=dtype,
                                         quiet=True))
                cases.append(bench.codec(unpack, new, old, timed=False,
                                         label=dtype, quiet=True))
    emit({"phase": "kernel_edges", "kernels": sorted({c["name"]
                                                      for c in cases}),
          "dtypes": list(CODEC_DTYPES), "N": [1, 511, 513, 70_001],
          "W": [1, 8, 64], "cases": n_aligned,
          "offset_cases": len(cases) - n_aligned,
          "offsets_bytes": [[4, 4], [8, 8], [4, 8]],
          "offset_shapes": [[1, 7], [513, 3], [1025, 5], [70_001, 9]],
          "max_abs_diff": max(c["max_abs_diff"] for c in cases),
          "stats_compared": "per tile", "gpu": bench.smi})


def at_offset(t: torch.Tensor, off: int) -> torch.Tensor:
    """A contiguous copy of ``t`` whose base lies ``off`` bytes past a
    16-byte boundary."""
    nbytes = t.numel() * t.element_size()
    buf = torch.empty(nbytes + 32, dtype=torch.uint8, device=t.device)
    start = -buf.data_ptr() % 16 + off
    x = buf[start:start + nbytes].view(t.dtype).view(t.shape)
    x.copy_(t)
    check(x.data_ptr() % 16 == off, f"base {x.data_ptr() % 16}, not {off}")
    return x


def phase_kernel_edges_scan(bench: KernelBench, rng) -> None:
    """The single-pass scan at ragged and large C, compared only and
    summarized in one line: C = 1, a tile - 1, a tile and a tile + 1,
    C > 2^24 (counts past 24 bits in the status words), Q = 1/2/8/64, and
    two calls back to back on one stream with no sync between them."""
    from repro_torch.kernels.batched_select import TILE as tile
    kops, ref = bench.kops, bench.kops.ref
    ts_max = 2**31 - 2
    sizes = [1, 2047, 2049, tile - 1, tile, tile + 1, 5 * tile + 3, 100_003]
    cases = []
    for c in sizes:
        ts = np.sort(rng.integers(-5, 97, c)).astype(np.int32)
        ts[-1] = ts_max
        ts_t = torch.as_tensor(ts, device=DEV)
        for q in (1, 2, 8, 64):
            tq = rng.integers(-10, 110, q).astype(np.int32)
            tq[0] = ts_max
            tq[-1] = -(2**31) + 1
            cases.append(bench.masked_cumsum(
                ts_t, torch.as_tensor(tq, device=DEV), timed=False,
                quiet=True))
    big = 2**24 + 3
    ts_t = torch.as_tensor(rng.integers(0, 100, big).astype(np.int32),
                           device=DEV)
    for tq in ([99], [99, 50]):
        cases.append(bench.masked_cumsum(
            ts_t, torch.as_tensor(np.array(tq, np.int32), device=DEV),
            timed=False, quiet=True))
    tq_t = torch.as_tensor(np.array([99, 50], np.int32), device=DEV)
    first = kops.batched_masked_cumsum(ts_t, tq_t)
    second = kops.batched_masked_cumsum(ts_t, tq_t)
    want = ref.ref_batched_masked_cumsum(ts_t, tq_t)
    sync()
    check(torch.equal(first, want) and torch.equal(second, want),
          "two back-to-back scans on one stream differ from the plain one")
    check(int(want[0, -1]) == big, "the C > 2^24 case did not count past "
          "24 bits")
    emit({"phase": "kernel_edges_scan", "tile": tile, "C": sizes + [big],
          "Q": [1, 2, 8, 64], "back_to_back": True, "cases": len(cases),
          "max_abs_diff": max(c["max_abs_diff"] for c in cases),
          "gpu": bench.smi})


def phase_kernel_edges_decode(bench: KernelBench, rng) -> None:
    """The decode-at-index gather, bit for bit against its plain version
    and summarized in one line: packed int8/int16/int32 lanes into stored
    1/2/4-byte ints, W 1/3/8/64 (whole 4-byte chunks and single lanes), a
    misaligned field, the XOR path, int32 and int64 indices at 0, C - 1,
    repeated and unsorted, an empty index, cells before the first head,
    and one 10,000-cell chain; then on the 16-byte path (packed int8 W 64,
    int16 W 8 and 64, int32 W 4 and 64) chains of 7, 8, 9, 15, 16 and 17
    cells across the 8-byte words of head flags, with and without a head
    at cell 0, the flags at bases 0, 1 and 5 bytes past a 16-byte
    boundary, every cell taken (0 first, repeated, unsorted)."""
    cases = []
    c = 5001
    for packed in (np.int8, np.int16, np.int32):
        info = np.iinfo(packed)
        for w in (1, 3, 8, 64):
            deltas = rng.integers(info.min, info.max, (c, w), endpoint=True,
                                  dtype=packed)
            heads = rng.random(c) < 0.3
            heads[0] = False
            idx = np.concatenate([[0, c - 1, 0, c - 1],
                                  rng.integers(0, c, 997)])
            d = torch.as_tensor(deltas, device=DEV)
            h = torch.as_tensor(heads, device=DEV)
            for size in (1, 2, 4):
                for it in (np.int64, np.int32):
                    cases.append(bench.chain_decode(
                        d, h, torch.as_tensor(idx.astype(it), device=DEV),
                        size, timed=False, quiet=True))
            size = np.dtype(packed).itemsize
            cases.append(bench.chain_decode(
                d, h, torch.as_tensor(idx, device=DEV), size, xor=True,
                timed=False, quiet=True))
            cases.append(bench.chain_decode(
                d, h, torch.zeros(0, dtype=torch.int64, device=DEV), size,
                timed=False, quiet=True))
            # the same field one byte past 4-byte alignment: single lanes
            raw = torch.empty(d.numel() * d.element_size() + 1,
                              dtype=torch.int8, device=DEV)
            off = raw[1:].view(d.dtype).view(c, w) if size == 1 else None
            if off is not None:
                off.copy_(d)
                cases.append(bench.chain_decode(
                    off, h, torch.as_tensor(idx, device=DEV), 4,
                    timed=False, quiet=True))
    chain = torch.as_tensor(rng.integers(-128, 127, (10_000, 8),
                                         dtype=np.int8), device=DEV)
    for first_head in (True, False):
        heads = torch.zeros(10_000, dtype=torch.bool, device=DEV)
        heads[0] = first_head
        idx = torch.as_tensor(np.array([9_999, 0, 5_000, 9_999]),
                              device=DEV)
        cases.append(bench.chain_decode(chain, heads, idx, 4, timed=False,
                                        quiet=True))
        cases.append(bench.chain_decode(chain, heads, idx, 1, xor=True,
                                        timed=False, quiet=True))
    n_old = len(cases)
    c2, lengths, h_offsets = 1000, (7, 8, 9, 15, 16, 17), (0, 1, 5)
    fields = ((np.int8, 64), (np.int16, 8), (np.int16, 64), (np.int32, 4),
              (np.int32, 64))
    idx = torch.as_tensor(np.concatenate([[0, 0, c2 - 1],
                                          rng.permutation(c2), [0, 5, 5]]),
                          device=DEV)
    for length in lengths:
        for first in (0, 3):  # 3: cells 0-2 chain from cell 0, no head
            heads = np.zeros(c2, bool)
            heads[first::length] = True
            for h_off in h_offsets:
                h = at_offset(torch.as_tensor(heads, device=DEV), h_off)
                for packed, w in fields:
                    info = np.iinfo(packed)
                    d = torch.as_tensor(rng.integers(
                        info.min, info.max, (c2, w), endpoint=True,
                        dtype=packed), device=DEV)
                    cases.append(bench.chain_decode(d, h, idx, 4,
                                                    timed=False, quiet=True))
                    if h_off == 0:
                        cases.append(bench.chain_decode(
                            d, h, idx, d.element_size(), xor=True,
                            timed=False, quiet=True))
    window = cases[n_old:]
    check(all(x["shape"]["vec_bytes"] == 16 for x in window),
          "a window case left the 16-byte path")
    emit({"phase": "kernel_edges_decode", "C": c, "W": [1, 3, 8, 64],
          "packed": ["int8", "int16", "int32"], "itemsize": [1, 2, 4],
          "chain_cells": 10_000, "cases": n_old,
          "window_C": c2, "window_chain_lengths": list(lengths),
          "window_fields": [[np.dtype(p).name, w] for p, w in fields],
          "window_heads_offsets": list(h_offsets),
          "window_cases": len(window),
          "vec_bytes": sorted({x["shape"]["vec_bytes"] for x in cases}),
          "max_abs_diff": max(x["max_abs_diff"] for x in cases),
          "gpu": bench.smi})


def phase_kernel_edges_sharding(bench: KernelBench, rng) -> None:
    """The sharding slice's kernels at edge shapes, compared only and
    summarized in one line: the route's two entry points (padded lanes,
    and flat key bytes, also from a buffer whose keys start 3 bytes in) at
    the empty key, keys whose real bytes end in zeros and keys of 125+
    bytes (the rotation wraps past 31 lanes), for 1, 2, 5 and 7 shards,
    each against its plain version and against the other; the stacked
    scan at S = 1/3/4, ragged C with int32-max padding, Q = 1/8/64, and its
    boundary sample at boundaries 0 and C."""
    kops, ref = bench.kops, bench.kops.ref
    edge = [b"", b"\x00", b"a", b"a\x00", b"a\x00\x00\x00\x00", b"x" * 125,
            b"y" * 200 + b"\x00",
            bytes(rng.integers(0, 256, 257, dtype=np.uint8))]
    cases = []
    for n in (1, 513, 100_003):
        keys = (edge + keys_of(np.arange(n)))[:n]
        lanes, lens = (torch.as_tensor(a, device=DEV)
                       for a in kops.key_lanes(keys))
        flat, offsets = kops.key_bytes(keys)
        for pre in (0, 3):
            f = torch.as_tensor(np.concatenate([np.full(pre, 0xAB, np.uint8),
                                                flat]), device=DEV)[pre:]
            o = torch.as_tensor(offsets, device=DEV)
            for n_shards in (1, 2, 5, 7):
                if pre == 0:
                    cases.append(bench.shard_route(lanes, lens, n_shards,
                                                   timed=False, quiet=True))
                cases.append(bench.shard_route_bytes(
                    f, o, n_shards, timed=False, quiet=True))
                got = kops.shard_route_bytes(f, o, n_shards)
                want = kops.shard_route(lanes, lens, n_shards)
                sync()
                check(torch.equal(got, want), f"the route's entry points "
                      f"differ at N {n}, {n_shards} shards")
    from repro_torch.kernels.batched_select import TILE as tile
    stacked_c = (1, 2047, 2049, tile - 1, tile, tile + 1, 5001)
    for s in (1, 3, 4):
        for c in stacked_c:
            ts = np.full((s, c), INT32.max, np.int32)
            for i in range(s):  # real cells, then padding (none in row 0)
                n_real = c if i == 0 else int(rng.integers(0, c + 1))
                ts[i, :n_real] = np.sort(rng.integers(-5, 97, n_real))
            bnd = np.sort(rng.integers(0, c + 1, (s, 9)), axis=1)
            bnd[:, 0], bnd[:, -1] = 0, c
            ts_t = torch.as_tensor(ts, device=DEV)
            bnd_t = torch.as_tensor(bnd.astype(np.int32), device=DEV)
            for q in (1, 2, 8, 64):
                tq = rng.integers(-10, 110, q).astype(np.int32)
                tq[0] = 2**31 - 2
                tq_t = torch.as_tensor(tq, device=DEV)
                cases.append(bench.stacked_masked_cumsum(
                    ts_t, tq_t, timed=False, quiet=True))
                got = kops.stacked_boundary_select(ts_t, tq_t, bnd_t)
                want = ref.ref_stacked_boundary_select(ts_t, tq_t, bnd_t)
                sync()
                check(torch.equal(got, want),
                      f"stacked_boundary_select S {s} C {c} Q {q} differs")
    emit({"phase": "kernel_edges_sharding",
          "kernels": sorted({c["name"] for c in cases}),
          "route_N": [1, 513, 100_003], "route_shards": [1, 2, 5, 7],
          "route_bytes_pre": [0, 3],
          "stacked_S": [1, 3, 4], "stacked_C": list(stacked_c),
          "stacked_Q": [1, 2, 8, 64], "cases": len(cases),
          "boundary_selects_compared": 3 * len(stacked_c) * 4,
          "max_abs_diff": max(c["max_abs_diff"] for c in cases),
          "gpu": bench.smi})


def phase_main_path(VersionedStore, FieldSchema, kops, releases) -> dict:
    """The main path on one store at full width, checked row by row."""
    reset_counts(kops)
    schema = [FieldSchema("sequence", SEQ_W, "int32"),
              FieldSchema("length", 1, "int32"),
              FieldSchema("annotation", ANN_W, "int32")]
    st = VersionedStore("uniprot_sprot", schema, capacity=N_ENTRIES)
    fields = [f.name for f in schema]
    rec = {"phase": "main_path", "entries": len(releases[0]["ids"]),
           "releases": len(releases), "update_s": []}
    prev = None
    for r in releases:
        keys = keys_of(r["ids"])
        info, s = wall(lambda: st.update(r["ts"], keys, r["table"]))
        rec["update_s"].append(s)
        if prev is None:
            want = (len(r["ids"]), 0, 0)
        else:
            both = np.isin(prev["ids"], r["ids"])
            i0 = np.nonzero(both)[0]
            i1 = np.searchsorted(r["ids"], prev["ids"][both])
            changed = np.zeros(len(i0), bool)
            for f in fields:
                changed |= (prev["table"][f][i0]
                            != r["table"][f][i1]).any(axis=1)
            want = (int((~np.isin(r["ids"], prev["ids"])).sum()),
                    int(changed.sum()), int((~both).sum()))
        check((info.n_new, info.n_updated, info.n_deleted) == want,
              f"release {r['ts']}: VersionInfo {info} != {want}")
        prev = r
    rec["entries_final"] = st.n_rows
    sl, rec["superlog_build_s"] = wall(st.superlog)
    rec["fused_cells"] = sl.n_cells
    seq = sl.fields["sequence"]
    check(seq.packed_host is not None, "the sequence field is not packed")
    # chain decode's launches by the gather size of the call that made
    # them: the timestamps of a get_versions or get_version call (1, 8 or
    # 64), or get_increments
    decode_launches = dict.fromkeys(("1", "8", "64", "increments"), 0)

    def counted(q, fn):
        before = kops.chain_decode_at.launches
        try:
            return fn()
        finally:
            decode_launches[q] += kops.chain_decode_at.launches - before

    _, rec["first_query_s"] = counted("1", lambda: wall(
        lambda: st.get_versions([RELEASE_TS[-1]])))
    queries = {1: [RELEASE_TS[-1]], 8: RELEASE_TS,
               64: sorted(set(np.linspace(5, 85, 64).astype(int).tolist()))}
    check(len(queries[64]) == 64, "64 distinct query timestamps")
    # the cells the Q = 1, 8 and 64 gathers take from the packed sequence
    # field, for timing its decode at the path's shapes, recorded in
    # untimed calls; the Q = 1 call also gives the device memory a Q = 1
    # query adds once the superlog is on the card (the packed gather
    # decodes only the taken cells)
    gathers, take = {}, seq.take_cells

    @contextlib.contextmanager
    def recording(q):
        seq.take_cells = lambda idx: (gathers.setdefault(q, idx.copy()),
                                      take(idx))[1]
        try:
            yield
        finally:
            del seq.take_cells

    sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with recording(1):
        counted("1", lambda: st.get_versions(queries[1]))
    sync()
    rec["get_versions_1_peak_added_bytes"] = (
        torch.cuda.max_memory_allocated() - base)
    for q in (8, 64):
        with recording(q):
            counted(str(q), lambda: st.get_versions(queries[q]))
    rec["get_versions_s"], rec["get_versions_stages_s"] = {}, {}
    for q, tss in queries.items():
        stages = {}
        views, s = counted(str(q), lambda: wall(
            lambda: st.get_versions(tss, trace=stages)))
        rec["get_versions_s"][str(q)] = s
        rec["get_versions_stages_s"][str(q)] = stages
        for t, v in zip(tss, views):
            check_view(v, releases, t, fields)
        del views
    rec["profile_get_versions_64"] = counted("64", lambda: device_profile(
        lambda: st.get_versions(queries[64])))
    pairs = list(zip(RELEASE_TS[:-1], RELEASE_TS[1:len(releases)]))

    def increments():
        return st.get_increments(pairs, significant_fields=["sequence"])

    incs, rec["get_increments_s"] = counted("increments",
                                            lambda: wall(increments))
    for (t0, t1), inc in zip(pairs, incs):
        check_increment(inc, release_at(releases, t0),
                        release_at(releases, t1))
    rec["increment_sizes"] = [len(i) for i in incs]
    del incs
    rec["profile_get_increments"] = counted(
        "increments", lambda: device_profile(increments))
    scan_ts = sl.ts[: sl.n_cells].clone()  # the scan's input, for timing
    st.drop_superlog()
    view, rec["cold_get_version_s"] = counted("1", lambda: wall(
        lambda: st.get_version(50)))
    check_view(view, releases, 50, fields)
    # the largest log compact() masks, for timing
    compact_ts = max((c.log.csr(st.n_rows)[1] for c in st.fields.values()),
                     key=len).astype(np.int32)
    stats, rec["compact_s"] = wall(lambda: st.compact(COMPACT_TS))
    rec["compact"] = stats
    check(st.versions[0].ts == COMPACT_TS and stats["cells_dropped"] > 0,
          "compact did not fold the history")
    after = [t for t in RELEASE_TS if t >= COMPACT_TS] + [55, 85]
    check(len(after) == 8, "8 timestamps after the compaction")
    for t, v in zip(after, counted("8", lambda: st.get_versions(after))):
        check_view(v, releases, t, fields)
    rec["launches"] = read_counts(kops)
    rec["chain_decode_launches_by_gather"] = decode_launches
    emit(rec)
    for name in PATH_KERNELS["main_path"]:
        check(rec["launches"][name] > 0,
              f"kernel {name} never launched on the main path")
    check(sum(decode_launches.values()) == rec["launches"]["chain_decode"],
          f"chain decode launches {decode_launches} do not add up to "
          f"{rec['launches']['chain_decode']}")
    for q in ("1", "8", "64"):
        check(decode_launches[q] > 0, f"no chain decode at Q = {q}")
    # the kernels line's decode rows count the launches of their gathers
    launches = {**rec["launches"], **{DECODE_ROWS[int(q)]: decode_launches[q]
                                      for q in ("1", "8", "64")}}
    return {"launches": launches, "scan_ts": scan_ts,
            "compact_ts": compact_ts, "gathers": gathers,
            "packed_seq": (seq.packed_host, seq.heads_host, seq.vals_host)}


def phase_kernel_main(bench: KernelBench, kops, compat, releases,
                      main_out) -> None:
    """Each kernel at the shapes the main path gave it, timed: the first
    release's field tables (570,000 entries), the fused ts that
    get_versions scanned (at Q = 8 and 64, and at Q = 1 in alternating
    rounds against torch.cumsum), the largest log that compact()
    masked, and the packed sequence field's decode at the cells its Q = 1,
    8 and 64 gathers took (one row each; every output checked against the
    sequence values on the card, in chunks, and freed before the next),
    with the device memory the Q = 1 decode adds beside its plain
    version's."""
    r = releases[0]
    for f in ("length", "annotation", "sequence"):
        lanes = kops.to_int_lanes(r["table"][f], DEV)
        bench.fingerprint(lanes, main=(f == "sequence"))
    scan_ts = main_out["scan_ts"]
    for q in (8, 64):
        tq = torch.as_tensor(np.linspace(5, 85, q).astype(np.int32),
                             device=DEV)
        bench.masked_cumsum(scan_ts, tq, main=(q == 64))
    # Q = 1: a call takes less time on the host than on the card, but not
    # much less, so the host's hiccups decide single readings against
    # torch.cumsum; time it in alternating rounds, and read each one's
    # device time alone from the profiler
    tq = torch.tensor([RELEASE_TS[-1]], dtype=torch.int32, device=DEV)
    bench.masked_cumsum(scan_ts, tq, main=True, rounds=TIMED_ROUNDS)
    mask = (scan_ts[None, :] <= tq[:, None]).to(torch.int32)
    per_call = {}
    for name, fn in (
            ("kernel", lambda: kops.batched_masked_cumsum(scan_ts, tq)),
            ("library", lambda: torch.cumsum(mask, dim=1,
                                             dtype=torch.int32))):
        fn()
        sync()
        prof = device_profile(lambda: [fn() for _ in range(TIMED_REPS)])
        per_call[name] = {k: ms / TIMED_REPS for k, ms in prof["top_ms"]}
    emit({"phase": "scan_q1_device", "C": scan_ts.shape[0], "Q": 1,
          "calls": TIMED_REPS, "device_ms_per_call": per_call,
          "gpu": bench.smi})
    del mask
    bench.keep_mask(torch.as_tensor(main_out["compact_ts"], device=DEV),
                    COMPACT_TS, main=True)
    packed, heads, vals = main_out.pop("packed_seq")
    d = torch.as_tensor(packed, device=DEV)
    h = torch.as_tensor(heads, device=DEV)
    size = vals.dtype.itemsize
    seq = torch.as_tensor(compat.bits_view(vals), device=DEV)
    for q, idx in sorted(main_out.pop("gathers").items()):
        idx_t = torch.as_tensor(idx, device=DEV)
        rec = bench.chain_decode(d, h, idx_t, size, main=True,
                                 name=DECODE_ROWS[q], label=f"Q = {q} gather")
        got = kops.chain_decode_at(d, h, idx_t, itemsize=size)
        check(all(torch.equal(got[i:i + GATHER_CHUNK],
                              seq.index_select(0, idx_t[i:i + GATHER_CHUNK]))
                  for i in range(0, len(idx), GATHER_CHUNK)),
              f"the Q = {q} decode does not give back the sequence values")
        if q != 1:
            del got, idx_t
            continue
        added = {}
        for name, fn in (("kernel", kops.chain_decode_at),
                         ("plain", kops.ref_chain_decode_at)):
            del got
            sync()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            got = fn(d, h, idx_t, itemsize=size)
            sync()
            added[name] = torch.cuda.max_memory_allocated() - base
        emit({"phase": "chain_decode_memory", "shape": rec["shape"],
              "peak_added_bytes": added, "gpu": bench.smi})
        del got, idx_t


def tree_bytes(path: str) -> dict:
    """Every file under ``path``: relative path -> bytes."""
    out = {}
    for d, _, names in os.walk(path):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, path)] = f.read()
    return out


def save_stages(prof: cProfile.Profile) -> dict:
    """Seconds of a profiled save spent in its stages (cumulative)."""
    st = pstats.Stats(prof)
    want = {"cells_after": lambda f: f == "cells_after",
            "csr": lambda f: f == "csr",
            "chain_pack": lambda f: f == "_chain_pack_timed",
            "npz_compress": lambda f: f == "savez_compressed",
            "fsync": lambda f: f.endswith(".fsync>"),
            "sha256": lambda f: f.endswith(".openssl_sha256>"),
            "file_write": lambda f: f.startswith("<method 'write' of '_io."),
            "manifest": lambda f: f == "write_manifest"}
    out = {k: 0.0 for k in want}
    for (_file, _line, fn), (_cc, _nc, _tt, ct, _callers) in st.stats.items():
        for k, match in want.items():
            if match(fn):
                out[k] += ct
    return out


def phase_persistence(VersionedStore, FieldSchema, kops, releases,
                      root: str) -> dict:
    """The store built again with a save after every release, then a
    full save, lazy and eager loads, and compact(30, path=)."""
    reset_counts(kops)
    schema = [FieldSchema("sequence", SEQ_W, "int32"),
              FieldSchema("length", 1, "int32"),
              FieldSchema("annotation", ANN_W, "int32")]
    fields = [f.name for f in schema]
    st = VersionedStore("uniprot_sprot", schema, capacity=N_ENTRIES)
    inc_dir, full_dir = os.path.join(root, "inc"), os.path.join(root, "full")
    rec = {"phase": "persistence", "saves": []}
    inc_prof = cProfile.Profile()
    for r in releases:
        st.update(r["ts"], keys_of(r["ids"]), r["table"])
        if r is not releases[0]:
            inc_prof.enable()
        stats, s = wall(lambda: st.save(inc_dir))
        inc_prof.disable()
        rec["saves"].append({"ts": r["ts"], "s": s, "mode": stats["mode"],
                             "bytes_written": stats["bytes_written"],
                             "raw_bytes": stats["raw_bytes"],
                             "packed_bytes": stats["packed_bytes"]})
        check(stats["mode"] == ("full" if r is releases[0]
                                else "incremental"),
              f"save after release {r['ts']} was {stats['mode']}")
    rec["incremental_save_stages_s"] = save_stages(inc_prof)
    prof = cProfile.Profile()
    prof.enable()
    stats, rec["full_save_s"] = wall(lambda: st.save(full_dir,
                                                     force_full=True))
    prof.disable()
    rec["full_save"] = stats
    rec["full_save_stages_s"] = save_stages(prof)
    check(stats["mode"] == "full", "force_full did not rewrite")
    # the arrays the full save packed, for the codec's kernel timing
    codec_in = {f: st.fields[f].log.csr(st.n_rows)
                for f in ("sequence", "annotation")}
    del st
    # lazy open: only the manifest and the index, every segment stat-checked
    lazy, rec["lazy_open_s"] = wall(lambda: VersionedStore.load(inc_dir))
    pending = {f: len(lazy.fields[f].log._pending) for f in fields}
    check(all(n == len(releases) for n in pending.values()),
          f"lazy open read segments: {pending}")
    view, rec["first_pinned_query_s"] = wall(
        lambda: lazy.get_version(20, fields=["length"]))
    check_view(view, releases, 20, ["length"])
    after = {f: len(lazy.fields[f].log._pending) for f in fields}
    check(after["sequence"] == after["annotation"] == len(releases)
          and after["length"] == len(releases) - 2,
          f"the pinned query read other segments: {after}")
    rec["pending_after_pinned_query"] = after
    q8 = RELEASE_TS

    def check_q8(store, name):
        views, rec[f"get_versions_8_{name}_s"] = wall(
            lambda: store.get_versions(q8))
        for t, v in zip(q8, views):
            check_view(v, releases, t, fields)

    check_q8(lazy, "lazy")
    eager, rec["eager_open_s"] = wall(
        lambda: VersionedStore.load(inc_dir, lazy=False))
    check_q8(eager, "eager")
    del eager
    stats, rec["compact_path_s"] = wall(
        lambda: lazy.compact(COMPACT_TS, path=inc_dir))
    rec["compact_path"] = stats
    check(stats["segments_retained"] > 0 and stats["cells_dropped"] > 0,
          f"compact(path=) retained or dropped nothing: {stats}")
    del lazy
    reopened, rec["reopen_after_compact_s"] = wall(
        lambda: VersionedStore.load(inc_dir))
    later = [t for t in RELEASE_TS if t >= COMPACT_TS] + [55, 85]
    for t, v in zip(later, reopened.get_versions(later)):
        check_view(v, releases, t, fields)
    rec["views_checked"] = 1 + 2 * len(q8) + len(later)
    rec["launches"] = read_counts(kops)
    emit(rec)
    for name in PATH_KERNELS["persistence"]:
        check(rec["launches"][name] > 0,
              f"kernel {name} never launched on the persistence path")
    return {"launches": rec["launches"], "codec_in": codec_in}


def phase_persistence_parity(VersionedStore, FieldSchema, seed: int,
                             root: str) -> None:
    """One small history with int32, uint16 and float32 fields saved from
    device="cpu" and device="cuda": every file byte-identical."""
    releases = make_releases(PARITY_ENTRIES, len(RELEASE_TS), seed + 3)
    schema = [FieldSchema("sequence", SEQ_W, "int32"),
              FieldSchema("length", 1, "int32"),
              FieldSchema("annotation", ANN_W, "int32"),
              FieldSchema("flags", 2, "uint16"),
              FieldSchema("score", 1, "float32")]
    stores = [VersionedStore("parity", schema, device=d)
              for d in ("cpu", DEV)]
    dirs = [os.path.join(root, f"parity_{i}") for i in range(2)]
    frng = np.random.default_rng(seed + 4)
    files = 0
    for r in releases:
        table = dict(r["table"])
        n = len(r["ids"])
        table["flags"] = 65500 + frng.integers(0, 36, (n, 2), dtype=np.uint16)
        table["score"] = frng.normal(size=(n, 1)).astype(np.float32)
        outs = []
        for s, d in zip(stores, dirs):
            s.update(r["ts"], keys_of(r["ids"]), table)
            outs.append(s.save(d))
        check(outs[0] == outs[1], f"save stats differ at {r['ts']}")
    for step in ("saved", "compacted"):
        if step == "compacted":
            outs = [s.compact(COMPACT_TS, path=d)
                    for s, d in zip(stores, dirs)]
            check(outs[0] == outs[1], "compact(path=) stats differ")
        a, b = tree_bytes(dirs[0]), tree_bytes(dirs[1])
        check(sorted(a) == sorted(b), f"{step}: file lists differ")
        for k in a:
            check(a[k] == b[k], f"{step}: {k} differs between cpu and cuda")
        files += len(a)
    emit({"phase": "persistence_parity", "entries": PARITY_ENTRIES,
          "releases": len(releases), "files_compared": files,
          "identical": True})


def phase_codec_main(bench: KernelBench, compat, codec_in, rng) -> None:
    """The codec at the shapes of the persistence phase's full save: the
    sequence log (C x 64 int32) and the annotation log (C x 8 int32),
    each cell against its chain predecessor as chain_pack pairs them,
    with the int32 packs' device time per call (``codec_device``).
    The float XORs, the unpacks and the 8-byte ops, which no store of this
    schema reaches, are timed at the annotation log's shape."""
    pairs = {}
    for f, (vals, _tss, ptr) in codec_in.items():
        heads = np.zeros(len(vals), bool)
        heads[ptr[:-1][np.diff(ptr) > 0]] = True
        new = torch.as_tensor(compat.bits_view(vals), device=DEV)
        prev = torch.roll(new, 1, 0)
        prev[torch.as_tensor(heads, device=DEV)] = 0
        pairs[f] = (new, prev)
    # every row in alternating rounds with its library call: a wrapper
    # call's host work counts once per timing, so one timing can catch a
    # host hiccup
    rounds = TIMED_ROUNDS
    bench.codec("delta_pack", *pairs["sequence"], main=True, rounds=rounds)
    bench.codec("delta_pack", *pairs["annotation"], rounds=rounds)
    # the int32 packs' device time per call, queued so that no call's host
    # time counts, against torch.sub's, in alternating rounds (the
    # profiler's per-kernel sums missed launches of these calls)
    device = {}
    for f in ("sequence", "annotation"):
        a, b = pairs[f]
        rec = device[f] = {"shape": list(a.shape), "kernel_ms": [],
                           "library_ms": []}
        for _ in range(rounds):
            rec["kernel_ms"].append(queued_ms(
                lambda: bench.kops.delta_pack(a, b), TIMED_REPS))
            rec["library_ms"].append(queued_ms(lambda: torch.sub(a, b),
                                               TIMED_REPS))
        rec["kernel_median_ms"] = float(np.median(rec["kernel_ms"]))
        rec["library_median_ms"] = float(np.median(rec["library_ms"]))
    emit({"phase": "codec_device", "calls": TIMED_REPS, "rounds": rounds,
          "int32_pack": device, "gpu": bench.smi})
    bench.codec("delta_unpack", *pairs["annotation"], main=True,
                rounds=rounds)
    new, prev = pairs["annotation"]
    c, w = new.shape
    fl = torch.as_tensor(rng.normal(size=(c, w)).astype(np.float32),
                         device=DEV)
    fl_prev = torch.roll(fl, 1, 0)
    bench.codec("delta_pack", fl, fl_prev, rounds=rounds)
    bench.codec("delta_unpack", fl, fl_prev, rounds=rounds)
    wide, wide_prev = new.to(torch.int64) << 20, prev.to(torch.int64) << 20
    bench.codec("delta_pack_wide", wide, wide_prev, main=True, rounds=rounds)
    bench.codec("delta_unpack_wide", wide, wide_prev, main=True,
                rounds=rounds)
    fl64, fl64_prev = fl.to(torch.float64), fl_prev.to(torch.float64)
    bench.codec("delta_pack_wide", fl64, fl64_prev, rounds=rounds)
    bench.codec("delta_unpack_wide", fl64, fl64_prev, rounds=rounds)
    del pairs, fl, fl_prev, wide, wide_prev, fl64, fl64_prev


def uncounted(kops, fn, flash: dict | None = None):
    """Run ``fn`` (reference work beside a path) without adding to any
    kernel's launch count. ``flash``, a dict, gets the flash launches by
    design that ``fn`` made (the serving checks' f32 prefills)."""
    acc: dict = {}
    with launches_during(kops, acc):
        out = fn()
    if flash is not None:
        for d in kops.flash_attention.by_design:
            flash[d] = flash.get(d, 0) + acc[f"flash_attention.{d}"]
    return out


def same_bytes(x: np.ndarray, y: np.ndarray) -> bool:
    """Same dtype, shape and bytes, compared without copying."""
    return (x.dtype == y.dtype and x.shape == y.shape
            and np.array_equal(np.ascontiguousarray(x).view(np.uint8),
                               np.ascontiguousarray(y).view(np.uint8)))


def same_rows(a, b, what: str) -> None:
    """Two answers of the store byte for byte: keys, row ids, values."""
    check(a.keys == b.keys and same_bytes(a.row_idx, b.row_idx),
          f"{what}: rows differ")
    check(list(a.values) == list(b.values), f"{what}: fields differ")
    for f in a.values:
        check(same_bytes(a.values[f], b.values[f]), f"{what}: {f} differs")


# the sharding phase's cuts in depth, its line's "reduced"
SHARDING_REDUCED = {
    "get_versions_q64": "dropped under every placement (the stacked "
                        "placement's call, the unsharded store's answers "
                        "and the check of 64 views of 570,000 rows; the "
                        "serial placement's went earlier), for the "
                        "families phase's time; main_path keeps Q = 64 on "
                        "one store, and the kernel rows the stacked scan "
                        "at Q = 64",
    "serial_get_versions_q8": "dropped for the whisper phase's time: the "
                              "serial placement's Q = 8 call and the "
                              "check of its 8 views (3.3 s and the "
                              "checks); the stacked placement keeps Q = 8 "
                              "against the same answers, the serial one "
                              "Q = 1 and the increments",
    "lazy_reopen": "dropped for the families_train phase's time: the "
                   "saved sharded store's lazy reopen on the card and Q = 8 "
                   "after it against the unsharded store (1.7 + 7.6 s and "
                   "the checks); the full save stays, sharding_parity "
                   "reopens sharded saves, persistence lazy loads at this "
                   "scale on one store"}


def phase_sharding(core, placement, kops, releases, root: str) -> dict:
    """The releases through a 4-shard ShardedStore on the card, queried
    under every placement and checked row by row against the releases and
    byte for byte against an unsharded store, then compacted and saved
    (its lazy reopen is cut: SHARDING_REDUCED)."""
    schema = [core.FieldSchema("sequence", SEQ_W, "int32"),
              core.FieldSchema("length", 1, "int32"),
              core.FieldSchema("annotation", ANN_W, "int32")]
    fields = [f.name for f in schema]
    # the unsharded store whose answers the sharded ones must equal
    plain = core.VersionedStore("uniprot_sprot", schema, capacity=N_ENTRIES)
    for r in releases:
        uncounted(kops, lambda: plain.update(r["ts"], keys_of(r["ids"]),
                                             r["table"]))
    rec = {"phase": "sharding", "shards": N_SHARDS,
           "entries": len(releases[0]["ids"]), "releases": len(releases)}
    # route_keys alone on the last release's keys: its host packing of the
    # key bytes (key_bytes) and the whole call; beside them the padded
    # lanes' packing (key_lanes), which the store's path no longer runs
    last_keys = keys_of(releases[-1]["ids"])
    _, rec["key_bytes_s"] = wall(lambda: kops.key_bytes(last_keys))
    _, rec["route_keys_s"] = wall(lambda: uncounted(
        kops, lambda: kops.route_keys(last_keys, N_SHARDS, DEV)))
    _, rec["key_lanes_s"] = wall(lambda: kops.key_lanes(last_keys))
    rec["off_path"] = ["key_lanes_s"]
    reset_counts(kops)
    st = core.ShardedStore("uniprot_sprot", schema, n_shards=N_SHARDS,
                           capacity=N_ENTRIES)
    rec["update_s"], rec["session_apply_s"], rec["session_finish_s"] = (
        [], [], [])
    for r in releases:
        keys = keys_of(r["ids"])
        if r["ts"] <= 40:
            _, s = wall(lambda: st.update(r["ts"], keys, r["table"]))
            rec["update_s"].append(s)
            continue
        sess = st.begin_release(r["ts"], parallel=True)
        applies = []
        for part in np.array_split(np.arange(len(keys)), 4):
            chunk = [keys[i] for i in part]
            table = {f: v[part] for f, v in r["table"].items()}
            _, s = wall(lambda: sess.apply(chunk, table))
            applies.append(s)
        _, s = wall(sess.finish)
        rec["session_apply_s"].append(applies)
        rec["session_finish_s"].append(s)
    check(st.versions == plain.versions,
          "sharded VersionInfo differs from the unsharded store's")
    check(st.n_rows == plain.n_rows and st.row_keys == plain.row_keys,
          "sharded key order differs from the unsharded store's")
    rec["rows_per_shard"] = [st.shard(i).n_rows for i in range(N_SHARDS)]
    _, rec["superlog_build_s"] = wall(
        lambda: [st.shard(i).superlog() for i in range(N_SHARDS)])
    # Q = 64 is cut (SHARDING_REDUCED); the stacked scan at Q = 64 is
    # still timed in phase_kernel_sharding
    queries = {1: [RELEASE_TS[-1]], 8: RELEASE_TS}
    rec["reduced"] = SHARDING_REDUCED
    pairs = list(zip(RELEASE_TS[:-1], RELEASE_TS[1:len(releases)]))
    placements = {"serial": placement.plan_placement(N_SHARDS,
                                                     force="serial"),
                  "stacked": placement.ShardPlacement("stacked")}
    cards = torch.cuda.device_count()
    if cards >= 2:
        # one shard per card, round robin when there are fewer than 4
        placements["mesh"] = placement.ShardPlacement("mesh", tuple(
            torch.device("cuda", i % cards) for i in range(N_SHARDS)))
    rec["mesh"] = ("run" if cards >= 2
                   else f"not run: {cards} card (mesh needs 2 or more)")
    # the unsharded answers, once (a placement switch drops the stacked
    # copy, so each placement runs all its queries in a row)
    want = {q: uncounted(kops, lambda: plain.get_versions(tss))
            for q, tss in queries.items()}
    want_inc = uncounted(kops, lambda: plain.get_increments(
        pairs, significant_fields=["sequence"]))
    rec["get_versions_s"] = {p: {} for p in placements}
    rec["get_versions_stages_s"] = {p: {} for p in placements}
    rec["get_increments_s"] = {}
    n_checked = 0
    for name, pl in placements.items():
        st.placement = pl
        if name == "stacked":
            _, rec["stacked_build_s"] = wall(st._placed_superlog)
            placed = st._placed
            rec["stacked_shape"] = {"S": N_SHARDS, "Cmax": placed.cmax,
                                    "Bmax": placed.bmax,
                                    "cells": placed.n_cells}
        for q, tss in queries.items():
            if name == "serial" and q == 8:
                continue  # cut for time (SHARDING_REDUCED)
            stages = {}
            views, s = wall(lambda: st.get_versions(tss, trace=stages))
            rec["get_versions_s"][name][str(q)] = s
            rec["get_versions_stages_s"][name][str(q)] = stages
            for t, v, w in zip(tss, views, want[q]):
                check_view(v, releases, t, fields)
                same_rows(v, w, f"{name} get_versions Q {q} at {t}")
            n_checked += len(views)
            del views
        incs, rec["get_increments_s"][name] = wall(
            lambda: st.get_increments(pairs, significant_fields=["sequence"]))
        for (t0, t1), inc, w in zip(pairs, incs, want_inc):
            check_increment(inc, release_at(releases, t0),
                            release_at(releases, t1))
            check(np.array_equal(inc.kind, w.kind),
                  f"{name} increment ({t0}, {t1}]: kinds differ")
            same_rows(inc, w, f"{name} increment ({t0}, {t1}]")
        n_checked += len(incs)
        del incs
        if name == "serial":  # each shard's own scan input, for timing
            shard_ts = [st.shard(i).superlog().ts[
                : st.shard(i).superlog().n_cells] for i in range(N_SHARDS)]
        if name == "stacked":
            rec["profile_stacked_get_versions_8"] = device_profile(
                lambda: st.get_versions(queries[8]))
    del want, want_inc
    # compact and one full save (the lazy reopen is cut: SHARDING_REDUCED)
    stats, rec["compact_s"] = wall(lambda: st.compact(COMPACT_TS))
    uncounted(kops, lambda: plain.compact(COMPACT_TS))
    check(stats["cells_dropped"] > 0 and st.versions == plain.versions,
          f"sharded compact differs: {stats}")
    path = os.path.join(root, "sharded")
    stats, rec["save_s"] = wall(lambda: st.save(path))
    check(stats["mode"] == "full" and stats["n_shards"] == N_SHARDS,
          f"first sharded save was {stats['mode']}")
    rec["save"] = stats
    rec["results_checked"] = n_checked
    rec["launches"] = read_counts(kops)
    emit(rec)
    for name in PATH_KERNELS["sharding"]:
        check(rec["launches"][name] > 0,
              f"kernel {name} never launched on the sharding path")
    return {"launches": rec["launches"],
            "stack": (placed._blocks[0][2], placed._blocks[0][3]),
            "shard_ts": shard_ts,
            "route_in": (*kops.key_bytes(last_keys),
                         *kops.key_lanes(last_keys))}


def phase_kernel_sharding(bench: KernelBench, sharding_out) -> None:
    """The sharding slice's kernels at the shapes the sharding phase gave
    them: the route of the last release's keys over 4 shards from their
    flat bytes (the path's entry point) and, beside it, from padded lanes,
    the stacked scan of the 4 shards' (S, Cmax) ts stack at Q = 1/8/64,
    and beside it the four per-shard scans the serial placement runs at
    Q = 64."""
    flat, offsets, lanes, lens = sharding_out.pop("route_in")
    bench.shard_route_bytes(torch.as_tensor(flat, device=DEV),
                            torch.as_tensor(offsets, device=DEV), N_SHARDS,
                            main=True)
    bench.shard_route(torch.as_tensor(lanes, device=DEV),
                      torch.as_tensor(lens, device=DEV), N_SHARDS, main=True)
    ts, _bnd = sharding_out.pop("stack")
    for q in (1, 8, 64):
        tq = torch.as_tensor(np.linspace(5, 85, q).astype(np.int32),
                             device=DEV)
        bench.stacked_masked_cumsum(ts, tq, main=(q == 64))
    # the serial placement's scans of the same cells: one unstacked scan
    # per shard over its own fused ts (no padding), back to back
    shard_ts = sharding_out.pop("shard_ts")
    emit({"phase": "serial_vs_stacked_scan", "Q": 64,
          "shard_cells": [int(t.shape[0]) for t in shard_ts],
          "four_serial_scans_ms": cuda_ms(
              lambda: [bench.kops.batched_masked_cumsum(t, tq)
                       for t in shard_ts], bench.reps),
          "stacked_ms": bench.main["stacked_masked_cumsum"]["kernel_ms"],
          "stacked_shape": {"S": ts.shape[0], "C": ts.shape[1]},
          "gpu": bench.smi})
    del ts, _bnd, shard_ts


def phase_sharding_parity(core, seed: int, root: str) -> None:
    """One small sharded history with int32, uint16 and float32 fields
    saved from device="cpu" and device="cuda": SHARD_MANIFEST.json and
    every shard's files byte-identical, after compact(path=) too."""
    releases = make_releases(PARITY_ENTRIES, len(RELEASE_TS), seed + 5)
    schema = [core.FieldSchema("sequence", SEQ_W, "int32"),
              core.FieldSchema("length", 1, "int32"),
              core.FieldSchema("annotation", ANN_W, "int32"),
              core.FieldSchema("flags", 2, "uint16"),
              core.FieldSchema("score", 1, "float32")]
    stores = [core.ShardedStore("parity", schema, n_shards=N_SHARDS,
                                device=d) for d in ("cpu", DEV)]
    dirs = [os.path.join(root, f"sharded_parity_{i}") for i in range(2)]
    frng = np.random.default_rng(seed + 6)
    files = 0
    for r in releases:
        table = dict(r["table"])
        n = len(r["ids"])
        table["flags"] = 65500 + frng.integers(0, 36, (n, 2), dtype=np.uint16)
        table["score"] = frng.normal(size=(n, 1)).astype(np.float32)
        outs = []
        for s, d in zip(stores, dirs):
            s.update(r["ts"], keys_of(r["ids"]), table)
            outs.append(s.save(d))
        check(outs[0] == outs[1], f"sharded save stats differ at {r['ts']}")
    for step in ("saved", "compacted"):
        if step == "compacted":
            outs = [s.compact(COMPACT_TS, path=d)
                    for s, d in zip(stores, dirs)]
            check(outs[0] == outs[1], "sharded compact(path=) stats differ")
        a, b = tree_bytes(dirs[0]), tree_bytes(dirs[1])
        check(sorted(a) == sorted(b), f"{step}: file lists differ")
        check("SHARD_MANIFEST.json" in a, "no shard manifest")
        for k in a:
            check(a[k] == b[k], f"{step}: {k} differs between cpu and cuda")
        files += len(a)
    emit({"phase": "sharding_parity", "entries": PARITY_ENTRIES,
          "shards": N_SHARDS, "releases": len(releases),
          "files_compared": files, "identical": True})


def phase_parity(VersionedStore, FieldSchema, seed: int) -> None:
    """The same small history through device="cpu" and device="cuda"."""
    releases = make_releases(PARITY_ENTRIES, len(RELEASE_TS), seed + 1)
    schema = [FieldSchema("sequence", SEQ_W, "int32"),
              FieldSchema("length", 1, "int32"),
              FieldSchema("annotation", ANN_W, "int32"),
              FieldSchema("flags", 2, "uint16")]
    stores = [VersionedStore("parity", schema, device=d)
              for d in ("cpu", DEV)]
    frng = np.random.default_rng(seed + 2)
    for r in releases:
        table = dict(r["table"])
        # near the top of uint16: sign-extended lanes, packed deltas
        table["flags"] = 65500 + frng.integers(0, 36, (len(r["ids"]), 2),
                                               dtype=np.uint16)
        for s in stores:
            s.update(r["ts"], keys_of(r["ids"]), table)
    stores[0].delete(85, keys_of(releases[-1]["ids"][:7]))
    stores[1].delete(85, keys_of(releases[-1]["ids"][:7]))

    def same(a, b, what):
        check(a.keys == b.keys, f"{what}: keys differ")
        for f in a.values:
            check(a.values[f].dtype == b.values[f].dtype
                  and np.array_equal(a.values[f].view(np.uint8),
                                     b.values[f].view(np.uint8)),
                  f"{what}: {f} differs")

    qs = [5, 10, 35, 80, 85, 2**31]
    pairs = [(10, 20), (-1, 50), (70, 85)]
    n_checked = 0
    for phase in ("cold", "warm", "compacted"):
        if phase == "warm":
            for s in stores:
                s.superlog()
        if phase == "compacted":
            for s in stores:
                s.compact(COMPACT_TS)
            qs = [30, 45, 80, 85]
        for q in qs:  # one ts at a time takes the cold path when not warm
            same(stores[0].get_version(q), stores[1].get_version(q),
                 f"{phase} get_version({q})")
        for a, b in zip(stores[0].get_versions(qs), stores[1].get_versions(qs)):
            same(a, b, f"{phase} get_versions")
        for a, b in zip(
                stores[0].get_increments(pairs, significant_fields=["sequence"]),
                stores[1].get_increments(pairs, significant_fields=["sequence"])):
            check(np.array_equal(a.kind, b.kind), f"{phase} increment kinds")
            same(a, b, f"{phase} get_increments")
        n_checked += len(qs) * 2 + len(pairs)
        check(stores[0]._version_digests == stores[1]._version_digests,
              f"{phase}: digests differ")
        check(stores[0].versions == stores[1].versions,
              f"{phase}: VersionInfo differs")
    emit({"phase": "cpu_gpu_parity", "entries": PARITY_ENTRIES,
          "releases": len(releases), "results_compared": n_checked,
          "digest": stores[1]._history_digest,
          "digests_equal": True})


# ---------------------------------------------------------------------------
# the serving tier: TieredStorePool, GeStoreService, FrontDoor
# ---------------------------------------------------------------------------

FD_STORES = ("uniprot", "uniprot4")  # one VersionedStore, one of 4 shards
FD_READERS = 4
FD_READ_TS = (40, 60, 80)  # pinned released versions, above FD_COMPACT_TS
FD_FIELDS = (("sequence", "length"), None)  # None: every field
FD_UPDATE_EVERY = 50  # table9_serving's mix: one ingest per 50 requests
FD_COMPACT_TS = 30
# the saturated drain (every request submitted at once) measures the rate
# the door sustains; the paced drain then runs open loop at FD_RATE_SHARE
# of it. Each drain lands 3 or more updates per store
FD_SAT_REQUESTS, FD_PACED_REQUESTS = 320, 320
FD_RATE_SHARE = 0.5
# the budgeted drain: four blocks of (store, reads, whether an update of
# the store lands first), one store hot in each, so the pool demotes,
# spills and reloads without thrashing: the third reloads the plain store
# from its spill, and the fourth (its update a plan miss) makes the pool
# demote that reloaded store
FD_BUDGET_BLOCKS = (("uniprot", 48, True), ("uniprot4", 48, True),
                    ("uniprot", 32, False), ("uniprot4", 32, True))
FD_DEMOTION_FREED = 0.9  # a demotion frees this share of its counted bytes


def fd_update(i: int, store: str, rng, releases, next_ts: dict) -> dict:
    """An update of the first 1% of the last release's keys (new sequence
    and length values) at ``store``'s next fresh timestamp, by its writer
    tenant (table9_serving's ``N // 100`` keys, patch semantics)."""
    keys = keys_of(releases[-1]["ids"][:len(releases[-1]["ids"]) // 100])
    ts = next_ts[store]
    next_ts[store] += 10
    return {"i": i, "kind": "update", "store": store,
            "tenant": f"writer-{store}", "ts": ts, "keys": keys, "table": {
                "sequence": rng.integers(0, 25, (len(keys), SEQ_W),
                                         dtype=np.int32),
                "length": rng.integers(50, 400, (len(keys), 1),
                                       dtype=np.int32)}}


def fd_schedule(n: int, rng, releases, next_ts: dict) -> list[dict]:
    """table9_serving's open-loop traffic over the two stores: request i
    goes to store i % 2 and is a read by tenant ``reader-(i // 2 % 4)``
    (each reader reads both stores) at a pinned version, with the
    sequence and length fields or every field; every 50th is an update
    (:func:`fd_update`), the stores in turn; at the middle, each writer
    also submits compact(FD_COMPACT_TS)."""
    out, n_upd = [], 0
    for i in range(n):
        if i == n // 2:
            for s in FD_STORES:
                out.append({"i": i, "kind": "compact", "store": s,
                            "tenant": f"writer-{s}"})
        if i and i % FD_UPDATE_EVERY == 0:
            out.append(fd_update(i, FD_STORES[n_upd % 2], rng, releases,
                                 next_ts))
            n_upd += 1
            continue
        f = FD_FIELDS[int(rng.integers(0, len(FD_FIELDS)))]
        out.append({"i": i, "kind": "read", "store": FD_STORES[i % 2],
                    "tenant": f"reader-{(i // 2) % FD_READERS}",
                    "ts": FD_READ_TS[int(rng.integers(0, len(FD_READ_TS)))],
                    "fields": f})
    return out


def fd_submit(fd, r: dict):
    if r["kind"] == "read":
        return fd.submit(r["tenant"], r["store"], r["ts"], fields=r["fields"])
    if r["kind"] == "update":
        return fd.submit_update(r["tenant"], r["store"], r["ts"], r["keys"],
                                r["table"], full_release=False)
    return fd.submit_compact(r["tenant"], r["store"], FD_COMPACT_TS)


def fd_drain(fd, schedule: list[dict], rate: float | None) -> dict:
    """Submit ``schedule`` to a started door from one thread per tenant,
    open loop: request i at t0 + i / rate (all at once without a rate).
    Waits for every future, then for the door to count every request (it
    counts after it resolves a future); an exception in a submitting
    thread, or a future that carries one, fails the run. Returns the
    futures aligned with the schedule, the order in which each store's
    mutations resolved, the door's stats with this drain's counters alone
    and the walls."""
    import threading
    before = fd.stats()["counters"]
    settled = ("completed", "failed", "cancelled", "shed_deadline")
    by_tenant: dict[str, list[int]] = {}
    for j, r in enumerate(schedule):
        by_tenant.setdefault(r["tenant"], []).append(j)
    futs: list = [None] * len(schedule)
    resolved: dict[str, list] = {s: [] for s in FD_STORES}
    lock, errs = threading.Lock(), []

    def done_cb(r):
        def cb(f):
            with lock:
                resolved[r["store"]].append(r.get("ts", "compact"))
        return cb

    def submitter(idx: list[int]):
        try:
            for j in idx:
                if rate is not None:
                    delay = t0 + schedule[j]["i"] / rate - time.perf_counter()
                    if delay > 0:
                        time.sleep(delay)
                f = fd_submit(fd, schedule[j])
                if schedule[j]["kind"] != "read":
                    f.add_done_callback(done_cb(schedule[j]))
                futs[j] = f
        except Exception as e:  # noqa: BLE001 — fails the run below
            errs.append(repr(e))

    threads = [threading.Thread(target=submitter, args=(idx,),
                                name=f"submit-{t}")
               for t, idx in by_tenant.items()]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    submit_s = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "a submitter hung")
    check(not errs, f"submitting threads raised: {errs}")
    for f in futs:
        f.exception(timeout=900)  # waits; raises only on a timeout
    span = time.perf_counter() - t0
    failed = [(r["kind"], r["store"], repr(f.exception()))
              for r, f in zip(schedule, futs) if f.exception() is not None]
    check(not failed, f"futures carry exceptions: {failed[:4]}")
    while True:
        stats = fd.stats()
        c = stats["counters"]
        if sum(c[k] - before[k] for k in settled) >= len(schedule):
            break
        check(time.perf_counter() - t0 < span + 900, "the door never "
              "counted its last requests")
        time.sleep(0.001)
    for k, v in before.items():
        c[k] -= v
    return {"futures": futs, "resolved": resolved, "stats": stats,
            "submit_s": submit_s, "span_s": span}


def fd_report(out: dict, target: float | None) -> dict:
    s, c = out["stats"], out["stats"]["counters"]
    lat = s["latency"]
    return {"requests": c["admitted"], "span_s": out["span_s"],
            "submit_s": out["submit_s"], "target_rate": target,
            "achieved_rate": c["completed"] / out["span_s"],
            "p50_ms": lat["total"]["p50_ms"], "p99_ms": lat["total"]["p99_ms"],
            "exec_p50_ms": lat["exec"]["p50_ms"],
            "exec_p99_ms": lat["exec"]["p99_ms"],
            "stages_p50_ms": {k: lat[k]["p50_ms"] for k in
                              ("queue", "scan", "gather", "materialize")},
            "waves": c["waves"], "read_waves": c["read_waves"],
            "mutation_waves": c["mutation_waves"], "riders": c["riders"],
            "serial_degrades": c["serial_degrades"],
            "plan_hits": s["service"]["plan_hits"],
            "plan_misses": s["service"]["plan_misses"],
            "batches": s["service"]["batches"], "pool": s.get("pool"),
            "pool_pressure": s["pool_pressure"]}


def fd_check(out: dict, schedule: list[dict], want, what: str) -> None:
    """No failure and no shed request; every read equal to the store's
    answer after the drain (``want``), byte for byte; each store's
    mutations resolved in their submission order, each update at its
    timestamp."""
    c = out["stats"]["counters"]
    check(c["failed"] == 0 and c["cancelled"] == 0,
          f"{what}: {c['failed']} failed, {c['cancelled']} cancelled")
    check(c["rejected_queue_full"] == c["rejected_pressure"]
          == c["shed_deadline"] == 0, f"{what}: requests shed: {c}")
    check(c["completed"] == len(schedule), f"{what}: {c['completed']} of "
          f"{len(schedule)} completed")
    seen = set()
    for r, f in zip(schedule, out["futures"]):
        got = f.result(0)
        if r["kind"] == "update":
            check(got.ts == r["ts"], f"{what}: update resolved at {got.ts}")
        if r["kind"] != "read" or id(got) in seen:
            continue
        seen.add(id(got))
        same_rows(got, want(r["store"], r["ts"], r["fields"]),
                  f"{what}: {r['store']}@{r['ts']} {r['fields']}")
    for s in FD_STORES:
        sub = [r.get("ts", "compact") for r in schedule
               if r["kind"] != "read" and r["store"] == s]
        check(out["resolved"][s] == sub,
              f"{what}: {s}'s mutations resolved as {out['resolved'][s]}, "
              f"submitted as {sub}")


def phase_frontdoor(core, kops, releases, root: str) -> dict:
    """The serving tier on the card at UniProtKB/Swiss-Prot scale: two
    stores of its own from the main path's releases behind a FrontDoor
    (shard_placement="parallel": the 4-shard store stacked on one card),
    driven open loop from threads, then behind a second door with a
    memory budget that makes its pool demote, spill and reload."""
    from concurrent.futures import Future
    from repro_torch.serve import (FrontDoor, FrontDoorConfig,
                                   GeStoreService, VersionRequest)
    schema = [core.FieldSchema("sequence", SEQ_W, "int32"),
              core.FieldSchema("length", 1, "int32"),
              core.FieldSchema("annotation", ANN_W, "int32")]
    rec = {"phase": "frontdoor", "stores": {}, "readers": FD_READERS,
           "read_ts": list(FD_READ_TS), "update_every": FD_UPDATE_EVERY,
           "update_keys": len(releases[-1]["ids"]) // 100,
           "fields": [list(f) if f else "all" for f in FD_FIELDS]}
    reset_counts(kops)
    stores = {"uniprot": core.VersionedStore("uniprot", schema,
                                             capacity=N_ENTRIES),
              "uniprot4": core.ShardedStore("uniprot4", schema,
                                            n_shards=N_SHARDS,
                                            capacity=N_ENTRIES)}
    for name, st in stores.items():
        _, s = wall(lambda: [st.update(r["ts"], keys_of(r["ids"]), r["table"])
                             for r in releases])
        rec["stores"][name] = {"build_s": s, "rows": st.n_rows,
                               **({"shards": st.n_shards}
                                  if name == "uniprot4" else {})}
    rng = np.random.default_rng(int(releases[0]["ids"][-1]))
    next_ts = dict.fromkeys(FD_STORES, RELEASE_TS[-1] + 10)

    cfg = FrontDoorConfig(max_queue_per_tenant=1 << 16)
    # one service (plan cache, pool with the pinned placement) behind a
    # door per drain, so each drain's counters and latencies are its own
    svc = GeStoreService(stores, shard_placement="parallel")
    check(svc.store("uniprot4").placement.mode == "stacked",
          "the 4-shard store is not stacked on one card")
    drains = []
    for share in (None, FD_RATE_SHARE):
        sched = fd_schedule(FD_SAT_REQUESTS if share is None
                            else FD_PACED_REQUESTS, rng, releases, next_ts)
        rate = None if share is None else share * drains[0][2][
            "achieved_rate"]
        svc_before = dict(svc.stats)
        with FrontDoor(svc, config=cfg) as fd:
            out = fd_drain(fd, sched, rate)
        for k, v in svc_before.items():  # this drain's service stats
            out["stats"]["service"][k] -= v
        drains.append((sched, out, fd_report(out, rate)))
    # the pinned versions after both drains, from the same stores
    want_cache = {}

    def want(store, ts, fields):
        key = (store, fields)
        if key not in want_cache:
            want_cache[key] = dict(zip(FD_READ_TS, svc.store(store)
                                       .get_versions(list(FD_READ_TS),
                                                     fields=fields)))
        return want_cache[key][ts]

    for name in FD_STORES:
        for fields in FD_FIELDS:
            for t in FD_READ_TS:
                check_view(want(name, t, fields), releases, t,
                           list(fields) if fields else
                           [f.name for f in schema])
    for label, (sched, out, rep) in zip(("saturated", "paced"), drains):
        fd_check(out, sched, want, label)
        rec[label] = rep
        rec[label]["updates_per_store"] = {
            s: sum(r["kind"] == "update" and r["store"] == s for r in sched)
            for s in FD_STORES}
        check(min(rec[label]["updates_per_store"].values()) >= 3,
              f"{label}: fewer than 3 updates a store")
    del drains
    # the device over one read wave of each store (plan cache cleared):
    # its wall alone, then under the profiler with every device operation
    # bracketed by CUDA events (device_profile)
    rec["wave_profile"] = {}
    for name in FD_STORES:
        def wave():
            svc._plans.clear()
            items = [(VersionRequest(name, t, ("sequence", "length")),
                      Future()) for t in FD_READ_TS]
            return lambda: svc.serve_wave(items), items
        run, _ = wave()
        _, plain = wall(run)
        run, items = wave()
        rec["wave_profile"][name] = device_profile(run, spans=True,
                                                   plain_wall_s=plain)
        for _, f in items:
            same_rows(f.result(0), want(name, f.result(0).ts,
                                        ("sequence", "length")),
                      f"profiled wave of {name}")
    svc._plans.clear()
    rec["budgeted"] = phase_frontdoor_budget(core, stores, cfg, want, rng,
                                             releases, next_ts, root)
    rec["launches"] = read_counts(kops)
    emit(rec)
    for k in PATH_KERNELS["frontdoor"]:
        check(rec["launches"][k] > 0,
              f"kernel {k} never launched on the frontdoor path")
    return {"launches": rec["launches"]}


@contextlib.contextmanager
def watched_demotions(classes, demotions: list):
    """Record every device -> host demotion (``drop_superlog``) of a store
    of ``classes`` while the block runs, whichever object the pool holds
    (a store it reloaded from a spill included): the store, whether it is
    one of the stores the block started with, the device bytes its
    ``nbytes()`` counted and the bytes ``torch.cuda.memory_allocated()``
    fell by. A sharded store's drop of its own shards is part of its one
    demotion."""
    depth = threading.local()
    saved = {cls: cls.drop_superlog for cls in classes}

    def wrap(drop):
        def watched(st):
            if getattr(depth, "n", 0):
                return drop(st)
            sync()
            counted = st.nbytes()["device"]
            before = torch.cuda.memory_allocated()
            depth.n = 1
            try:
                drop(st)
            finally:
                depth.n = 0
            sync()
            demotions.append({"store": st.name, "id": id(st),
                              "counted_bytes": counted,
                              "freed_bytes":
                              before - torch.cuda.memory_allocated()})
        return watched

    for cls, drop in saved.items():
        cls.drop_superlog = wrap(drop)
    try:
        yield demotions
    finally:
        for cls, drop in saved.items():
            cls.drop_superlog = drop


def phase_frontdoor_budget(core, stores, cfg, want, rng, releases, next_ts,
                           root: str) -> dict:
    """The same stores behind a door whose pool holds a budget between
    the larger store's host bytes and both stores' resident bytes: reads
    in blocks that keep one store hot at a time (FD_BUDGET_BLOCKS), the
    last after the pool has spilled and reloaded the plain store.
    Every answer must equal the unbounded door's; every demotion the pool
    counts is watched where the pool makes it, one of them of a store it
    reloaded, and each must free at least FD_DEMOTION_FREED of the device
    bytes ``nbytes()`` counted for its store."""
    from repro_torch.serve import FrontDoor
    nb = {n: st.nbytes() for n, st in stores.items()}
    host = max(v["host"] for v in nb.values())
    resident = sum(sum(v.values()) for v in nb.values())
    budget = (host + resident) // 2
    first = {id(st) for st in stores.values()}
    spill_root = os.path.join(root, "spill")
    blocks, outs = [], []

    def served(fd, sched, what):
        out = fd_drain(fd, sched, None)
        fd_check(out, sched, want, what)
        outs.append(out)
        return out

    t0 = time.perf_counter()
    with watched_demotions((core.VersionedStore, core.ShardedStore),
                           []) as demotions, \
            FrontDoor(stores, config=cfg, memory_budget_bytes=budget,
                      spill_root=spill_root,
                      shard_placement="parallel") as fd:
        for b, (name, n, update_first) in enumerate(FD_BUDGET_BLOCKS):
            span = 0.0
            if update_first:
                upd = [fd_update(0, name, rng, releases, next_ts)]
                span += served(fd, upd, f"budgeted update {b}")["span_s"]
            reads = [{"i": i, "kind": "read", "store": name,
                      "tenant": f"reader-{i % FD_READERS}",
                      "ts": FD_READ_TS[int(rng.integers(0, len(FD_READ_TS)))],
                      "fields": FD_FIELDS[i % len(FD_FIELDS)]}
                     for i in range(n)]
            out = served(fd, reads, f"budgeted block {b}")
            blocks.append({"store": name, "reads": n,
                           "updates": int(update_first),
                           "span_s": span + out["span_s"],
                           "pool": out["stats"]["pool"]})
        span = time.perf_counter() - t0
        final = fd.stats()
    rep = {"budget_bytes": budget, "larger_host_bytes": host,
           "resident_bytes": resident, "nbytes": nb, "blocks": blocks,
           **fd_report({"stats": final, "span_s": span,
                        "submit_s": sum(o["submit_s"] for o in outs)}, None),
           "final_pressure": final["pool_pressure"], "demotions": demotions}
    for d in demotions:
        d["reloaded"] = d.pop("id") not in first
    pool = final["pool"]
    for k in ("demotions", "spills", "shard_spills", "reloads"):
        check(pool[k] >= 1, f"budgeted drain: no {k}: {pool}")
    check(len(demotions) == pool["demotions"],
          f"{len(demotions)} demotions watched, the pool counts "
          f"{pool['demotions']}")
    check(any(d["reloaded"] and d["counted_bytes"] > 0 for d in demotions),
          f"no demotion of a reloaded store held device bytes: {demotions}")
    check(all(d["freed_bytes"] >= FD_DEMOTION_FREED * d["counted_bytes"]
              for d in demotions),
          f"a demotion freed less than it counted: {demotions}")
    return rep


# ---------------------------------------------------------------------------
# the facade slice: GeStore, the streaming ingest, WorkflowManager
# ---------------------------------------------------------------------------

# the first release's entries (UniProtKB/Swiss-Prot scale) and the second's:
# 1% new entries, 3% of the sequences changed (synth_uniprot_chunks' churn)
#: the facade's releases: a quarter of UniProtKB/Swiss-Prot's 570,000
#: entries (GS_REDUCED), UniProt's widths, 1% new and 3% churn in the second
GS_ENTRIES, GS_NEW, GS_CHURN = 143_000, 0.01, 0.03
GS_TS = (10, 20)
GS_PARITY_ENTRIES = 20_000
# the gestore phase's cuts in depth and scale, its line's "reduced"
GS_REDUCED = {
    "one_shard_store": "dropped: the one-shard store that add_release gave "
                       "each whole release text (two parses and updates, "
                       "its generate_files_batch, cached and reopened "
                       "batches, its share of flush); gestore_parity keeps "
                       "one at 20,000 entries. Dropped too, for the whisper "
                       "phase's time: the batch the reopened GeStore "
                       "regenerated after its cache was evicted (13.4 s "
                       "profiled, its files' hashes against the first "
                       "batch's)",
    "entries": "cut in scale for the families_train phase's time: each "
               "release 143,000 entries (then 144,430), a quarter of "
               "Swiss-Prot's 570,000 (at full scale the two releases' "
               "writes and streamed ingests took 144.4 s of the phase's "
               "177.2 s on an H100 80GB HBM3 at 700 W); the widths, "
               "churn, new share, shards and every check stay"}
# 1,000 entries of the first release and 1,000 of the second's new ones
GS_KEY_FILTER = r"^P0014(2|3)"
# the first accession and the sequence lines of a UniProtKB entry
_AC_SQ = re.compile(r"^AC   ([^;\s]+);.*?^SQ   [^\n]*\n(.*?)^//$",
                    re.M | re.S)


def gestore_registry(core, parser):
    """The facade's plugins: ``blastp`` writes FASTA of the sequences and
    merges with the e-value merger (every hit kept), ``annot`` writes the
    same FASTA but changes only with the annotation."""
    from repro_torch.core.parsers.uniprot import BLAST_SIGNIFICANT
    reg = core.PluginRegistry()
    reg.register_parser(parser)
    reg.register_tool(core.ToolPlugin(
        "blastp", core.FileGenerator(
            parser="uniprot_dat", output_fields=["sequence", "length"],
            significant_fields=list(BLAST_SIGNIFICANT)),
        merger=core.BlastEvalueMerger(),
        params={"max_hits_per_query": 10**9}))
    reg.register_tool(core.ToolPlugin("annot", core.FileGenerator(
        parser="uniprot_dat", output_fields=["sequence"],
        significant_fields=["annotation"])))
    return reg


def gestore_requests(store: str) -> list[dict]:
    """One batch: both full versions, both tools' increments, a filter."""
    t0, t1 = GS_TS
    return [{"tool": "blastp", "store": store, "t_version": t0},
            {"tool": "blastp", "store": store, "t_version": t1},
            {"tool": "blastp", "store": store, "t_version": t1, "t_last": t0},
            {"tool": "annot", "store": store, "t_version": t1, "t_last": t0},
            {"tool": "blastp", "store": store, "t_version": t1,
             "key_filter": GS_KEY_FILTER}]


def release_fasta(path: str, width: int) -> dict[bytes, str]:
    """Accession -> the FASTA entry an unmodified BLAST reads, in release
    order, from a release file's AC and SQ lines by a regex (not the
    parser), the sequence cut to the store's ``width``."""
    with open(path, encoding="latin-1") as f:
        text = f.read()
    out = {}
    for m in _AC_SQ.finditer(text):
        seq = "".join(m.group(2).split())[:width]
        lines = [seq[i:i + 60] for i in range(0, len(seq), 60)] or [""]
        out[m.group(1).encode()] = (f">{m.group(1)}\n" + "\n".join(lines)
                                    + "\n")
    return out


@contextlib.contextmanager
def timed_calls(obj, name: str, acc: dict, key=None):
    """Add the seconds of every call of ``obj.name`` during the block to
    ``acc[key(args, kwargs)]`` (``acc[name]`` without ``key``)."""
    orig, own = getattr(obj, name), name in vars(obj)

    def wrapper(*a, **k):
        t0 = time.perf_counter()
        try:
            return orig(*a, **k)
        finally:
            slot = key(a, k) if key else name
            acc[slot] = acc.get(slot, 0.0) + time.perf_counter() - t0
    setattr(obj, name, wrapper)
    try:
        yield acc
    finally:
        if own:
            setattr(obj, name, orig)
        else:
            delattr(obj, name)


@contextlib.contextmanager
def fingerprint_by_width(kops):
    """Fingerprint launches during the block by row width in lanes (every
    store path fingerprints through ``kops.fingerprint``)."""
    import threading
    real, by_w, lock = kops.fingerprint, {}, threading.Lock()

    def counting(lanes):
        out = real(lanes)
        if lanes.is_cuda and lanes.shape[0]:  # the wrapper launched
            with lock:
                by_w[lanes.shape[1]] = by_w.get(lanes.shape[1], 0) + 1
        return out
    kops.fingerprint = counting
    try:
        yield by_w
    finally:
        kops.fingerprint = real


def gestore_batch(gs, store: str, profile: bool = False):
    """One ``generate_files_batch`` of ``gestore_requests(store)``: its
    results and its wall split into increments, the size context, full
    versions and format + cache put (with ``profile``, its device
    profile too)."""
    st, parser = gs.open_store(store), gs.registry.parsers["uniprot_dat"]
    acc = dict.fromkeys(("increments_s", "size_context_s",
                         "full_versions_s", "format_put_s"), 0.0)
    box = []

    def run():
        box.append(gs.generate_files_batch(gestore_requests(store)))
    with contextlib.ExitStack() as es:
        es.enter_context(timed_calls(st, "get_increments", acc,
                                     lambda a, k: "increments_s"))
        es.enter_context(timed_calls(
            st, "get_versions", acc, lambda a, k: (
                "size_context_s" if k.get("fields") == ["length"]
                else "full_versions_s")))
        for obj, name in ((parser, "format_view"), (gs.cache, "put")):
            es.enter_context(timed_calls(obj, name, acc,
                                         lambda a, k: "format_put_s"))
        if profile:
            prof = device_profile(run)
            acc["wall_s"] = prof["wall_s"]
            acc["profile"] = prof
        else:
            _, acc["wall_s"] = wall(run)
    return box[0], acc


def file_sha(path: str) -> str:
    import hashlib
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def fasta_entries(text: str) -> dict[str, str]:
    """FASTA text -> {accession: entry}."""
    return {e.split("\n", 1)[0]: e for e in text.split(">")[1:]}


def check_generated(gens, want: list[str], store: str) -> None:
    """Each generated file byte for byte against its expected text (where
    they differ, how many entries and the first)."""
    for g, w, r in zip(gens, want, gestore_requests(store)):
        with open(g.path, encoding="latin-1") as f:
            got = f.read()
        if got != w:
            a, b = fasta_entries(got), fasta_entries(w)
            bad = [k for k in b if a.get(k) != b[k]]
            check(False, f"{store} {r}: generated file differs from the "
                  f"FASTA of the release text: {len(a)} entries against "
                  f"{len(b)}, {len(bad)} differ or are missing, "
                  f"{len(set(a) - set(b))} extra, same order: "
                  f"{list(a) == list(b)}; first: {bad[:1]} "
                  f"{a.get(bad[0], '')[:80]!r} for {b[bad[0]][:80]!r}"
                  if bad else f"{store} {r}: entries reordered")
        check(g.n_entries == w.count(">"), f"{store} {r}: entry count")


def phase_gestore(core, kops, seed: int, root: str) -> dict:
    """The GeStore facade at a quarter of UniProtKB/Swiss-Prot's scale on
    the card (GS_ENTRIES): two releases written by ``write_synth_uniprot``,
    streamed into a 4-shard
    store (journal, saves; a reader of version 10 on another thread while
    the second streams); one generate_files_batch (profiled), again from
    the cache, merge_files, flush; a new GeStore over the root, its
    stores' histories checked and its cache evicted. Every generated file
    is checked against FASTA written from the release text. Cut in depth
    (the line's ``reduced``): no one-shard store given the whole release
    text by ``add_release`` (its two ingests, batches and save were about
    70 s of the script); ``phase_gestore_parity`` keeps one at 20,000
    entries; no batch regenerated by the reopened GeStore (15 s)."""
    import threading
    from repro_torch.core.ingest import write_synth_uniprot
    from repro_torch.core.parsers import UniProtParser
    parser = UniProtParser()
    rec = {"phase": "gestore", "entries": [GS_ENTRIES,
                                           int(GS_ENTRIES * (1 + GS_NEW))],
           "churn": GS_CHURN, "shards": N_SHARDS,
           "reduced": GS_REDUCED,
           "widths": {f.name: [f.width, f.dtype] for f in parser.schema()},
           "write_release_s": []}
    paths, fasta = [], []
    for ts, n, churn in zip(GS_TS, rec["entries"], (0.0, GS_CHURN)):
        p = os.path.join(root, f"uniprot_{ts}.dat")
        _, s = wall(lambda: write_synth_uniprot(p, n, seed=seed, churn=churn))
        paths.append(p)
        rec["write_release_s"].append(s)
        fasta.append(release_fasta(p, parser.seq_width))
    r0, r1 = fasta
    check([len(r0), len(r1)] == rec["entries"], "release entry counts")
    new = [k for k in r1 if k not in r0]
    changed = [k for k in r1 if k in r0 and r0[k] != r1[k]]
    rec["new_entries"], rec["changed_sequences"] = len(new), len(changed)
    check(new and changed, "the second release has no new or changed entry")
    new_set, changed_set = set(new), set(changed)
    filt = re.compile(GS_KEY_FILTER.encode())
    want = ["".join(r0.values()), "".join(r1.values()),
            "".join(v for k, v in r1.items()
                    if k in new_set or k in changed_set),
            "".join(r1[k] for k in new),
            "".join(v for k, v in r1.items() if filt.search(k))]

    reset_counts(kops)
    gs_root = os.path.join(root, "gestore")
    reg = gestore_registry(core, parser)
    with fingerprint_by_width(kops) as fp_by_w:
        gs = core.GeStore(gs_root, reg)
        check(gs.device.type == torch.device(DEV).type,
              f"GeStore without device= is on {gs.device}")
        # -- the 4-shard store through the streaming ingest --------------
        rec["add_release_stream"] = []
        errs, reads, stop = [], [0], threading.Event()
        for ts, p in zip(GS_TS, paths):
            reader = None
            if ts == GS_TS[1]:
                st = gs.stores["uniprot"]
                v10 = st.get_versions([GS_TS[0]])[0]

                def read():
                    try:
                        while not stop.is_set():
                            same_rows(st.get_versions([GS_TS[0]])[0], v10,
                                      "version 10 during the ingest")
                            reads[0] += 1
                    except Exception as e:  # noqa: BLE001 — checked below
                        errs.append(repr(e))
                reader = threading.Thread(target=read, name="v10-reader")
                reader.start()
            try:
                rep, s = wall(lambda: gs.add_release_stream(
                    "uniprot", ts, p, parser_name="uniprot_dat",
                    shards=N_SHARDS))
            finally:
                if reader is not None:
                    stop.set()
                    reader.join(timeout=600)
                    check(not reader.is_alive(), "the reader did not stop")
            rec["add_release_stream"].append({
                "ts": ts, "wall_s": s, "entries": rep.n_entries,
                "entries_per_s": rep.entries_per_s, "chunks": rep.n_chunks,
                "checkpoint_writes": rep.checkpoint_writes,
                "ingest_wall_s": rep.wall_s})
        check(not errs, f"reader of version 10: {errs}")
        check(reads[0] > 0, "the reader made no read during the ingest")
        rec["reader_reads"] = reads[0]
        del v10
        infos = [(v.n_new, v.n_updated, v.n_deleted)
                 for v in gs.open_store("uniprot").versions]
        check(infos == [(len(r0), 0, 0), (len(new), len(changed), 0)],
              f"uniprot: VersionInfo {infos}")
        check(isinstance(gs.stores["uniprot"], core.ShardedStore)
              and gs.stores["uniprot"].n_shards == N_SHARDS,
              "the streamed store is not a 4-shard store")
        # -- generated files ----------------------------------------------
        gens = {}
        rec["generate_files_batch"], rec["cached_batch_s"] = {}, {}
        for name in ("uniprot",):
            gens[name], rec["generate_files_batch"][name] = gestore_batch(
                gs, name, profile=True)
            check([g.mode for g in gens[name]] ==
                  ["full", "full", "increment", "increment", "full"],
                  f"{name}: modes {[g.mode for g in gens[name]]}")
            check_generated(gens[name], want, name)
            again, rec["cached_batch_s"][name] = wall(
                lambda: gs.generate_files_batch(gestore_requests(name)))
            check({g.mode for g in again} == {"cached"},
                  f"{name}: the second batch was not all cached")
            check([g.path for g in again] == [g.path for g in gens[name]],
                  f"{name}: cached paths differ")
        # -- merge_files with a toy BLAST output ---------------------------
        ctx = gens["uniprot"][2].context
        check(ctx["db_size_old"] == sum(len(v) - v.count("\n") - len(k) - 1
                                        for k, v in r0.items()),
              "db_size_old is not the first release's residues")
        old = [k for k in list(r0)[:200] if k not in changed_set][:50]
        prev = "".join(f"q0\t{k.decode()}\t90.0\t180\t0\t0\t1\t180\t1\t180\t"
                       f"1.0e-10\t50.0\n" for k in changed[:50] + old)
        part = "".join(f"q0\t{k.decode()}\t95.0\t180\t0\t0\t1\t180\t1\t180\t"
                       f"1.0e-20\t80.0\n" for k in changed[:50] + new[:50])
        merged, rec["merge_files_s"] = wall(lambda: gs.merge_files(
            "blastp", prev, part, context=ctx))
        scale = math.log10(ctx["db_size_new"] / ctx["db_size_old"])
        rescaled = f"{10 ** (math.log10(1.0e-10) + scale):.2e}"
        rows = [ln.split("\t") for ln in merged.splitlines()]
        check(len(rows) == len(old) + len(changed[:50]) + len(new[:50])
              and all(r[10] == ("1.00e-20" if r[2] == "95.0" else rescaled)
                      for r in rows)
              and {r[1] for r in rows if r[2] == "90.0"}
              == {k.decode() for k in old},
              "merge_files: a stale hit or a wrong e-value")
        flushed, rec["flush_s"] = wall(gs.flush)
        rec["flush"] = flushed
        # -- a new GeStore over the root ----------------------------------
        gs2, rec["reopen_s"] = wall(lambda: core.GeStore(gs_root, reg))
        check(sorted(gs2.stores) == ["uniprot"]
              and not gs2.load_errors, f"reopen: {gs2.load_errors}")
        check(gs2.device.type == torch.device(DEV).type, "reopen device")
        check([(v.n_new, v.n_updated, v.n_deleted)
               for v in gs2.open_store("uniprot").versions] == infos,
              "reopen: the store's history differs")
        rec["evicted_files"] = gs2.cache.evict(0)
        check(rec["evicted_files"] == 5, "the cache held other files")
    rec["launches"] = read_counts(kops)
    rec["fingerprint_launches_by_width"] = {
        str(w): n for w, n in sorted(fp_by_w.items())}
    emit(rec)
    for name in PATH_KERNELS["gestore"]:
        check(rec["launches"][name] > 0,
              f"kernel {name} never launched on the gestore path")
    check(sum(fp_by_w.values()) == rec["launches"]["fingerprint"],
          "fingerprint launches by width do not add up")
    launches = {**rec["launches"], **{
        f"fingerprint_w{w}": fp_by_w.get(w, 0) for w in (512, 256)}}
    for w in (512, 256):
        check(launches[f"fingerprint_w{w}"] > 0, f"no fingerprint at W {w}")
    view = uncounted(kops, lambda: gs2.open_store("uniprot").get_versions(
        [GS_TS[0]], fields=["sequence", "annotation"])[0])
    return {"launches": launches, "rows": {
        512: view.values["sequence"], 256: view.values["annotation"]}}


def phase_kernel_gestore(bench: KernelBench, kops, gestore_out) -> None:
    """The fingerprint at the facade's widths: the first release's
    UniProt sequence (512 x int8) and annotation (256 x int8) rows as the
    store fingerprints them, one int32 lane an int8."""
    for w, rows in sorted(gestore_out.pop("rows").items(), reverse=True):
        lanes = kops.to_int_lanes(rows, DEV)
        check(tuple(lanes.shape) == (GS_ENTRIES, w),
              f"lanes {tuple(lanes.shape)}")
        bench.fingerprint(lanes, main=True, name=f"fingerprint_w{w}")
        del lanes


def phase_gestore_parity(core, seed: int, root: str) -> None:
    """A 20,000-entry history through GeStore(device="cpu") and
    GeStore(device="cuda"): a 4-shard store streamed and a one-shard store
    given whole, the same generated files and store directories after
    flush; an ingest into a 4-shard store on the card killed at half its
    chunks, reloaded and resumed, ending at the uninterrupted digests;
    and a WorkflowManager incremental run equal to a full one."""
    from repro_torch.core.ingest import (IngestConfig, ingest_release,
                                         write_synth_uniprot)
    from repro_torch.core.parsers import UniProtParser
    from repro_torch.workflow import Tool, WorkflowManager
    parser = UniProtParser()
    ns = [GS_PARITY_ENTRIES, int(GS_PARITY_ENTRIES * (1 + GS_NEW))]
    paths = [os.path.join(root, f"parity_{ts}.dat") for ts in GS_TS]
    for p, n, churn in zip(paths, ns, (0.0, GS_CHURN)):
        write_synth_uniprot(p, n, seed=seed + 7, churn=churn)
    roots = [os.path.join(root, f"gestore_parity_{i}") for i in range(2)]
    gss = [core.GeStore(r, gestore_registry(core, UniProtParser()), device=d)
           for r, d in zip(roots, ("cpu", DEV))]
    for ts, p in zip(GS_TS, paths):
        with open(p, encoding="latin-1") as f:
            text = f.read()
        for gs in gss:
            gs.add_release_stream("stream", ts, p, parser_name="uniprot_dat",
                                  shards=N_SHARDS)
            gs.add_release("whole", ts, text, parser_name="uniprot_dat")
    files = 0
    for name in ("stream", "whole"):
        a, b = (gs.generate_files_batch(gestore_requests(name)) for gs in gss)
        for x, y in zip(a, b):
            check((x.mode, x.n_entries, x.context) ==
                  (y.mode, y.n_entries, y.context)
                  and os.path.relpath(x.path, roots[0]) ==
                  os.path.relpath(y.path, roots[1])
                  and file_sha(x.path) == file_sha(y.path),
                  f"{name}: generated file differs between cpu and cuda")
            files += 1
    stats = [gs.flush() for gs in gss]
    check(stats[0] == stats[1], "flush stats differ between cpu and cuda")
    dirs = 0
    for name in ("stream", "whole"):
        a, b = (tree_bytes(gs.store_path(name)) for gs in gss)
        check(a == b, f"{name}: store directories differ")
        dirs += len(a)
    # -- killed at half its chunks, reloaded, resumed (on the card) -------
    cfg = IngestConfig(batch_entries=1024)
    n_chunks = -(-ns[0] // cfg.batch_entries)
    kill_at = n_chunks // 2 - 1

    class Killed(Exception):
        pass

    def killer(idx, _n, _replayed):
        if idx == kill_at:
            raise Killed

    sdir, jdir = (os.path.join(root, d) for d in ("resume_store",
                                                  "resume_journal"))
    st = core.ShardedStore("resume", parser.schema(), n_shards=N_SHARDS,
                           device=DEV)
    st.save(sdir)
    try:
        ingest_release(st, paths[0], parser, GS_TS[0], config=cfg,
                       journal_dir=jdir, store_dir=sdir, on_batch=killer)
        check(False, "the ingest was not killed")
    except Killed:
        pass
    st2 = core.ShardedStore.load(sdir, device=DEV)
    rep = ingest_release(st2, paths[0], parser, GS_TS[0], config=cfg,
                         journal_dir=jdir, store_dir=sdir)
    ref = core.ShardedStore("resume", parser.schema(), n_shards=N_SHARDS,
                            device=DEV)
    ingest_release(ref, paths[0], parser, GS_TS[0], config=cfg)

    def digests(s):
        return [s.shard(i)._history_digest for i in range(s.n_shards)]
    check(rep.chunks_replayed == kill_at + 1
          and rep.entries_replayed == (kill_at + 1) * cfg.batch_entries
          and rep.entries_parsed == ns[0] - rep.entries_replayed,
          f"resume: {rep}")
    check(digests(st2) == digests(ref)
          == digests(core.ShardedStore.load(sdir, device=DEV)),
          "the resumed store differs from an uninterrupted ingest")
    check(not os.path.exists(os.path.join(jdir, "JOURNAL.json")),
          "the journal was not cleared")

    # -- WorkflowManager: incremental equals full -------------------------
    def toy_blast(args):
        path = next(p for k, p in args.items() if k.startswith("store:"))
        with open(path) as f:
            text = f.read()
        out = []
        for entry in text.split(">")[1:]:
            sid = entry.splitlines()[0].split()[0]
            score = sum(map(ord, "".join(entry.splitlines()[1:]))) % 97
            out.append(f"q0\t{sid}\t90.0\t24\t0\t0\t1\t24\t1\t24\t"
                       f"{10 ** -(score % 20):.1e}\t{50 + score % 30}.0")
        return "\n".join(out) + "\n"

    def by_subject(text):
        return {c[1]: (c[2], c[11]) for c in
                (ln.split("\t") for ln in text.strip().splitlines())}

    outs = []
    for gs in gss:
        tools = [Tool("blastp", toy_blast, ["store:whole"])]
        wf = WorkflowManager(gs, tools)
        wf.run(db_version=GS_TS[0])
        inc = wf.run(db_version=GS_TS[1], last_version=GS_TS[0])
        full = WorkflowManager(gs, tools).run(db_version=GS_TS[1])
        check(inc.mode == "incremental"
              and by_subject(inc.outputs["blastp"])
              == by_subject(full.outputs["blastp"]),
              "workflow: the incremental run differs from the full run")
        outs.append((inc.outputs, full.outputs))
    check(outs[0] == outs[1], "workflow outputs differ between cpu and cuda")
    emit({"phase": "gestore_parity", "entries": ns, "shards": N_SHARDS,
          "files_compared": files, "store_files_compared": dirs,
          "resume": {"chunks": n_chunks, "killed_after": kill_at + 1,
                     "chunks_replayed": rep.chunks_replayed,
                     "entries_parsed": rep.entries_parsed},
          "workflow_subjects": len(by_subject(outs[1][1]["blastp"])),
          "identical": True})


# ---------------------------------------------------------------------------
# the serving slice: masked merge, flash attention, llama3.2-1b
# ---------------------------------------------------------------------------

FLASH_EDGE_SHAPES = [  # (B, Sq, Sk, H, K, D)
    (2, 256, 256, 8, 4, 64), (1, 100, 300, 4, 4, 32), (1, 1, 129, 8, 8, 64),
    (1, 37, 37, 2, 1, 128), (2, 128, 640, 4, 2, 16), (1, 45, 130, 14, 2, 64),
    (1, 150, 40, 4, 2, 32), (1, 1, 1, 4, 2, 128), (3, 65, 65, 4, 4, 16),
    # across the tensor-core kernels' tiles (bf16: 128 query rows, 128
    # keys; f32: 128 rows and 64 keys at D 64, 64 rows and 32 keys at
    # D 128): Sq 129 and 300 with Sk - Sq not a multiple of any key tile,
    # Sk 257, GQA groups 1/4/8, B 3, Sq = 1, Sq > Sk and an empty key
    # axis, at D 64 and 128
    (1, 129, 200, 8, 2, 64), (1, 300, 1000, 8, 8, 128),
    (2, 257, 257, 8, 1, 64), (3, 200, 333, 8, 2, 128),
    (1, 1, 300, 8, 1, 128), (2, 300, 130, 4, 1, 64),
    (1, 129, 129, 16, 2, 64), (1, 5, 0, 4, 2, 64),
    (1, 129, 200, 8, 2, 128), (2, 257, 257, 8, 1, 128),
    (2, 300, 130, 4, 1, 128), (1, 5, 0, 4, 2, 128),
    (1, 65, 97, 4, 4, 128), (2, 63, 65, 8, 4, 64), (3, 33, 33, 4, 2, 128),
    # D 16 and 32 (the mma kernels, 16-row strips, 32-key tiles, strips
    # and heads packed a block; bf16: mma, f32: mma_f32, three TF32
    # products): Sq and Sk on and off the tiles, GQA groups 1/2/4/8,
    # Sq = 1, Sq > Sk, an empty key axis, and the Meta-pipe encoder's
    # shape at a few sequences
    (2, 65, 97, 8, 2, 32), (3, 31, 33, 8, 1, 16), (1, 129, 257, 4, 2, 32),
    (6, 32, 32, 8, 8, 32), (1, 1, 65, 4, 1, 16), (2, 70, 20, 4, 4, 16),
    (1, 64, 64, 6, 3, 32), (2, 33, 0, 4, 2, 16),
    # across the mma kernels' packing: Sq 1, 16, 17, 33 and 65, each with
    # Sk >= Sq and Sk < Sq; GQA groups 1/2/4; head counts 6, 7 and 10,
    # whose heads a block (a divisor of H) are 6, 7, 2 or 1; a last strip
    # group short of strips (Sq 129 and 300 above)
    (2, 1, 40, 8, 2, 32), (1, 1, 1, 7, 7, 16), (3, 16, 16, 6, 3, 32),
    (2, 16, 9, 8, 8, 16), (2, 17, 50, 10, 5, 32), (1, 17, 5, 10, 5, 16),
    (2, 33, 33, 7, 7, 32), (1, 33, 20, 8, 4, 16), (1, 65, 100, 6, 3, 32),
    (2, 65, 40, 8, 2, 16),
    # D 112 (kimi-k2's heads; the wgmma designs in D 128's tiles, columns
    # past 112 zero-filled by TMA): its GQA group of 8, Sq and Sk on and
    # off the tiles, Sq = 1, Sq > Sk, an empty key axis
    (1, 129, 200, 16, 2, 112), (2, 300, 300, 8, 1, 112),
    (1, 1, 65, 8, 8, 112), (1, 65, 97, 4, 4, 112), (2, 150, 40, 8, 1, 112),
    (1, 5, 0, 8, 1, 112),
    # D 8 (qwen2-0.5b-smoke's heads; the mma designs, a k16 step over a
    # zero-padded row in bf16): 7 heads over 1 (7 heads a block, or 1),
    # 14 over 2, Sq 1 / 16 / 17 / 130, Sq > Sk, an empty key axis
    (2, 37, 37, 7, 1, 8), (1, 1, 40, 7, 1, 8), (3, 130, 200, 14, 2, 8),
    (2, 17, 5, 7, 7, 8), (1, 16, 16, 7, 1, 8), (1, 5, 0, 7, 1, 8),
]


#: layouts the kernels read through their plan, by head dim: at D 64
#: and 128 a q that is every other head of a wider tensor and a k whose
#: base is one element past an allocation (TMA cannot read it: copied);
#: at D 16 and 32 q, k and v as views of one fused projection, and a k
#: whose base is 8 bytes past a 16-byte boundary (the mma kernel's
#: 16-byte copies cannot read it: copied, then launched)
FLASH_EDGE_LAYOUTS = [(lay, d) for d in (64, 112, 128)
                      for lay in ("strided q", "misaligned k")] + [
    (lay, d) for d in (8, 16, 32)
    for lay in ("fused qkv", "k 8 bytes past 16")]


def flash_edge_inputs(gen, dt):
    """(q, k, v) at every FLASH_EDGE_SHAPES entry, then at every
    FLASH_EDGE_LAYOUTS entry."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=DEV).to(dt)
    for b, sq, sk, h, kh, d in FLASH_EDGE_SHAPES:
        yield randn(b, sq, h, d), randn(b, sk, kh, d), randn(b, sk, kh, d)
    for lay, d in FLASH_EDGE_LAYOUTS:
        if lay == "strided q":
            yield (randn(2, 200, 16, d)[:, :, ::2], randn(2, 200, 2, d),
                   randn(2, 200, 2, d))
        elif lay == "misaligned k":
            n = 1 * 150 * 2 * d
            yield (randn(1, 150, 8, d), randn(n + 1)[1:].view(1, 150, 2, d),
                   randn(1, 150, 2, d))
        elif lay == "fused qkv":
            x = randn(2, 48, (8 + 2 * 2) * d)
            yield (x[..., :8 * d].view(2, 48, 8, d),
                   x[..., 8 * d:10 * d].view(2, 48, 2, d),
                   x[..., 10 * d:].view(2, 48, 2, d))
        else:
            off, n = 8 // torch.empty((), dtype=dt).element_size(), 40 * 2 * d
            yield (randn(1, 40, 8, d), randn(n + off)[off:].view(1, 40, 2, d),
                   randn(1, 40, 2, d))


def phase_kernel_edges_serving(bench: KernelBench, rng) -> None:
    """The serving slice's kernels at edge shapes, compared only and
    summarized in one line."""
    cases = []
    gen = torch.Generator(device=DEV).manual_seed(int(rng.integers(2**31)))
    fa = bench.kops.flash_attention
    by_design = dict(fa.by_design)
    for dt in (torch.float32, torch.bfloat16):
        for q, k, v in flash_edge_inputs(gen, dt):
            cases.append(bench.flash(q, k, v, timed=False, quiet=True))
    n_flash = len(cases)
    # the bf16 layouts (the last cases): a strided q or a fused qkv read
    # as it lies, a k off its boundary copied first
    copied = {"strided q": [], "misaligned k": ["k"], "fused qkv": [],
              "k 8 bytes past 16": ["k"]}
    check([c["shape"]["copies"] for c in cases[-len(FLASH_EDGE_LAYOUTS):]]
          == [copied[lay] for lay, _ in FLASH_EDGE_LAYOUTS],
          "flash edges: the bf16 layouts' copies differ from their plans'")
    designs = {d: fa.by_design[d] - by_design[d] for d in by_design}
    # every case launched (an empty Sq launches nothing; none here) and
    # took the design its plan names
    check(designs == {d: sum(c["shape"]["design"] == d for c in cases)
                      for d in by_design},
          f"flash edges: {designs} launches by design")
    for n in (1, 511, 512, 513):
        for w in range(1, 10):
            for dtype in ("int8", "float16", "float32", "float64"):
                base, upd, _ = codec_pair(rng, dtype, n, w)
                rm = torch.as_tensor(rng.random(n) < 0.4, device=DEV)
                fm = torch.as_tensor(rng.random(w) < 0.7, device=DEV)
                for ts_dt in (np.int32, np.int64):
                    top = np.iinfo(ts_dt).max
                    ts = torch.as_tensor(rng.integers(0, top, n, dtype=ts_dt,
                                                      endpoint=True),
                                         device=DEV)
                    cases.append(bench.masked_merge(base, upd, rm, fm, ts, top,
                                                    timed=False, quiet=True))
    # what the kernels do not take raises on the card: no plain fallback
    refused = 0
    for call, exc in (
            (lambda: bench.kops.flash_attention(
                torch.zeros(1, 8, 4, 96, device=DEV),
                torch.zeros(1, 8, 2, 96, device=DEV),
                torch.zeros(1, 8, 2, 96, device=DEV)), ValueError),
            (lambda: bench.kops.flash_attention(
                *(torch.zeros(1, 8, 2, 64, device=DEV, dtype=torch.float16)
                  for _ in range(3))), TypeError),
            (lambda: bench.kops.masked_merge(
                *(torch.zeros(4, 2, device=DEV, dtype=torch.complex128)
                  for _ in range(2)), torch.ones(4, dtype=torch.bool,
                                                 device=DEV),
                torch.ones(2, dtype=torch.bool, device=DEV),
                torch.zeros(4, dtype=torch.int32, device=DEV), 1),
             TypeError)):
        try:
            call()
        except exc:
            refused += 1
    check(refused == 3, f"only {refused} of 3 unsupported inputs raised")
    flash_err = {dt: max(c["max_abs_diff"] for c in cases[:n_flash]
                         if c["shape"]["dtype"] == dt)
                 for dt in ("torch.float32", "torch.bfloat16")}
    merge_err = max(c["max_abs_diff"] for c in cases[n_flash:])
    emit({"phase": "kernel_edges_serving",
          "flash_shapes": FLASH_EDGE_SHAPES + [
              f"{lay}, D {d}" for lay, d in FLASH_EDGE_LAYOUTS],
          "flash_dtypes": ["float32", "bfloat16"],
          "flash_cases": n_flash, "flash_max_abs_diff": flash_err,
          "flash_designs": [c["shape"]["design"] for c in cases[:n_flash]],
          "flash_copies": [c["shape"]["copies"] for c in cases[:n_flash]],
          "flash_launches_by_design": designs,
          "flash_worst": {c["shape"]["dtype"]: [c["shape"], c["max_abs_diff"]]
                          for c in sorted(cases[:n_flash],
                                          key=lambda c: c["max_abs_diff"])},
          "flash_tol": {str(k): v for k, v in FLASH_TOL.items()},
          "merge_N": [1, 511, 512, 513], "merge_W": list(range(1, 10)),
          "merge_elem_bytes": [1, 2, 4, 8], "merge_ts": ["int32", "int64"],
          "merge_cases": len(cases) - n_flash, "merge_max_abs_diff": merge_err,
          "unsupported_inputs_raised": refused, "gpu": bench.smi})


def phase_kernel_edges_merge(bench: KernelBench, rng) -> None:
    """The masked merge's units, bit for bit, summarized in one line:
    rows of W * s bytes on and off a multiple of 16 (16-, 8-, 4-, 2-byte
    and one-element units), bases 0, 4 and 8 bytes past a 16-byte
    boundary (base and upd at the same and at different offsets), row
    masks all false, all true and mixed, field masks none, all and mixed
    (units with some lanes taken), over one and several blocks, and W 64
    int32 at N 511/512/513."""
    cases = []
    shapes = [("int32", 4), ("int32", 64), ("int32", 3), ("int32", 5),
              ("int8", 16), ("int8", 48), ("int8", 3), ("int8", 2),
              ("float16", 8), ("float16", 12), ("float64", 2),
              ("float64", 3), ("int64", 1)]
    offsets = [(0, 0), (4, 4), (8, 8), (4, 8)]
    masks = [(rk, fk) for rk in ("none", "all", "mixed")
             for fk in ("none", "all", "mixed")]
    for k, (dtype, w) in enumerate(shapes):
        size = np.dtype(dtype).itemsize
        for n in (1, 300, 3001):
            base0, upd0, _ = codec_pair(rng, dtype, n, w)
            for off_b, off_u in offsets:
                if off_b % size or off_u % size:
                    continue
                base, upd = at_offset(base0, off_b), at_offset(upd0, off_u)
                for j, (rk, fk) in enumerate(masks):
                    rm = torch.as_tensor({"none": np.zeros(n, bool),
                                          "all": np.ones(n, bool),
                                          "mixed": rng.random(n) < 0.4}[rk],
                                         device=DEV)
                    fm = torch.as_tensor({"none": np.zeros(w, bool),
                                          "all": np.ones(w, bool),
                                          "mixed": np.arange(w) % 2 == 0}[fk],
                                         device=DEV)
                    ts_dt = (np.int32, np.int64)[(k + j) % 2]
                    top = np.iinfo(ts_dt).max
                    ts = torch.as_tensor(rng.integers(0, top, n, dtype=ts_dt),
                                         device=DEV)
                    cases.append(bench.masked_merge(base, upd, rm, fm, ts,
                                                    top, timed=False,
                                                    quiet=True))
    for n in (511, 512, 513):
        base, upd, _ = codec_pair(rng, "int32", n, 64)
        for rk, fk in masks:
            rm = torch.as_tensor({"none": np.zeros(n, bool),
                                  "all": np.ones(n, bool),
                                  "mixed": rng.random(n) < 0.03}[rk],
                                 device=DEV)
            fm = torch.as_tensor({"none": np.zeros(64, bool),
                                  "all": np.ones(64, bool),
                                  "mixed": rng.random(64) < 0.5}[fk],
                                 device=DEV)
            ts = torch.as_tensor(rng.integers(0, 90, n), device=DEV)
            cases.append(bench.masked_merge(base, upd, rm, fm, ts, 99,
                                            timed=False, quiet=True))
    units = sorted({c["shape"]["vec_bytes"] for c in cases})
    check(units == [1, 2, 4, 8, 16], f"merge edges took units {units}")
    emit({"phase": "kernel_edges_merge",
          "shapes": [[d, w] for d, w in shapes], "N": [1, 300, 3001],
          "offsets_bytes": offsets, "masks": masks,
          "w64_int32_N": [511, 512, 513], "unit_bytes": units,
          "cases": len(cases),
          "max_abs_diff": max(c["max_abs_diff"] for c in cases),
          "gpu": bench.smi})


def phase_merge(kops, releases) -> dict:
    """masked_merge on the head table: the first release's sequence field
    (570,000 x 64 int32) takes the second release's rows where the
    entry's sequence changed; timestamps go to 20 on those rows."""
    reset_counts(kops)
    r0, r1 = releases[0], releases[1]
    base = r0["table"]["sequence"]
    alive = np.isin(r0["ids"], r1["ids"])
    upd = base.copy()
    upd[alive] = r1["table"]["sequence"][np.searchsorted(r1["ids"],
                                                         r0["ids"][alive])]
    rm = (upd != base).any(axis=1)
    fm = np.ones(base.shape[1], bool)
    ts = np.full(len(base), r0["ts"], np.int64)
    args = [torch.as_tensor(a, device=DEV) for a in (base, upd, rm, fm, ts)]
    (merged, ts_out), s = wall(lambda: kops.masked_merge(*args, r1["ts"]))
    check(np.array_equal(merged.cpu().numpy(),
                         np.where(rm[:, None] & fm[None, :], upd, base)),
          "masked_merge: merged rows differ from the numpy select")
    check(np.array_equal(ts_out.cpu().numpy(), np.where(rm, r1["ts"], ts)),
          "masked_merge: timestamps differ from the numpy select")
    rec = {"phase": "merge", "N": base.shape[0], "W": base.shape[1],
           "rows_merged": int(rm.sum()), "wall_s": s,
           "launches": read_counts(kops)}
    emit(rec)
    for name in PATH_KERNELS["merge"]:
        check(rec["launches"][name] > 0,
              f"kernel {name} never launched on the merge path")
    return {"launches": rec["launches"], "args": args, "ts_new": r1["ts"]}


def serving_requests(cfg, seed: int) -> list:
    """The JAX package's launcher's synthetic stream: prompts of 4-47
    tokens from a numpy generator seeded with ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(SERVE_REQUESTS):
        n = int(rng.integers(4, 48))
        out.append((f"req{i:04d}", rng.integers(3, cfg.vocab, size=n)))
    return out


def first_bucket(requests, max_batch: int):
    """The first batch the scheduler forms: the smallest bucket's first
    ``max_batch`` requests, right-padded with 0 (its pad id)."""
    from repro_torch.serve.scheduler import _bucket
    bucket = min(_bucket(len(t)) for _, t in requests)
    reqs = [(r, t) for r, t in requests if _bucket(len(t)) == bucket]
    reqs = reqs[:max_batch]
    batch = np.zeros((len(reqs), bucket), np.int32)
    for i, (_, t) in enumerate(reqs):
        batch[i, :len(t)] = t
    return [r for r, _ in reqs], batch


@contextlib.contextmanager
def layer0_inputs(n_layers: int):
    """Keep the q, k and v that each prefill hands the flash kernel at
    layer 0, by wrapping the attention module's ``flash_attention``; the
    kernel launches and counts as before. The prefill pads its caches
    into new tensors, so nothing writes to the kept ones afterwards."""
    from repro_torch.models import attention as A
    orig, kept, calls = A.flash_attention, [], [0]

    def wrapped(q, k, v):
        if calls[0] % n_layers == 0:
            kept.append((q, k, v))
        calls[0] += 1
        return orig(q, k, v)

    A.flash_attention = wrapped
    try:
        yield kept
    finally:
        A.flash_attention = orig


def greedy_logits(kops, cfg, params, batch, dev, steps: int, ids=None,
                  flash: dict | None = None):
    """The logits of ``batch``'s prefill and of ``steps`` decode steps
    after it, fed ``ids`` (B, steps) or, without them, this run's own
    greedy tokens: ((steps + 1, B, V) f32 on the host, the ids fed).
    ``flash``: as for :func:`uncounted`."""
    from repro_torch.models import build

    def run():
        bundle = build(cfg)
        logits, state = bundle.prefill(
            params, {"tokens": torch.as_tensor(batch, device=dev)},
            pad_to=batch.shape[1] + steps)
        out, fed = [logits[:, 0].cpu()], []
        for t in range(steps):
            tok = (ids[:, t:t + 1] if ids is not None
                   else out[-1].argmax(-1, keepdim=True))
            fed.append(tok)
            logits, state = bundle.decode(params, tok.to(dev), state)
            out.append(logits[:, 0].cpu())
        return (torch.stack(out),
                torch.cat(fed, 1) if fed else None)
    return uncounted(kops, run, flash)


def ring_decode_gap(kops, cfg, params, prompt, steps: int,
                    flash: dict | None = None) -> float:
    """The card's decode over the long prompt's ring against a prefill of
    the same tokens: max |logit difference| at the last of ``steps``
    greedy decode steps (the ring holds prompt + ``steps`` + 1 slots, as
    the served request's does). ``flash``: as for :func:`uncounted`."""
    from repro_torch.models import build

    def run():
        bundle = build(cfg)
        toks = torch.as_tensor(prompt.astype(np.int64), device=DEV)
        logits, state = bundle.prefill(params, {"tokens": toks},
                                       pad_to=toks.shape[1] + steps + 1)
        fed = []
        for _ in range(steps):
            fed.append(logits[:, 0].argmax(-1, keepdim=True))
            logits, state = bundle.decode(params, fed[-1], state)
        del state
        ref = bundle.prefill(params, {"tokens": torch.cat([toks, *fed],
                                                          1)})[0]
        return float((logits - ref).abs().max())
    return uncounted(kops, run, flash)


def phase_serving(kops, seed: int) -> dict:
    """llama3.2-1b at full width and depth through Scheduler and
    ServeEngine on the card, then one 32k-token request."""
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.models import build, weights
    from repro_torch.obs.recorder import RECORDER
    from repro_torch.serve import Scheduler, ServeConfig, ServeEngine
    cfg = get_config(ARCH)
    rec = {"phase": "serving", "arch": ARCH, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "params": cfg.param_count(),
           "dtype": cfg.dtype}
    t0 = time.perf_counter()
    tree = weights.random_tree(cfg, np.random.default_rng(seed))
    rec["weights_draw_s"] = time.perf_counter() - t0
    params, rec["weights_load_s"] = wall(
        lambda: weights.from_jax_tree(cfg, tree, device=DEV))
    rec["weights_bytes"] = sum(
        t.numel() * t.element_size() for t in
        [*params["embed"].values(), *params["final_norm"].values()]
        + [t for lay in params["layers"] for sub in lay.values()
           for t in sub.values()])
    engine = ServeEngine(cfg, params,
                         ServeConfig(max_new_tokens=SERVE_MAX_NEW),
                         run=RunConfig())
    sched = Scheduler(engine, max_batch=SERVE_MAX_BATCH)
    requests = serving_requests(cfg, seed)
    long_prompt = np.random.default_rng(seed + 1).integers(
        3, cfg.vocab, (1, LONG_PROMPT)).astype(np.int32)
    sync()
    torch.cuda.reset_peak_memory_stats()
    RECORDER.clear()
    reset_counts(kops)
    by_design = kops.flash_attention.by_design
    by_design.update(dict.fromkeys(by_design, 0))
    with layer0_inputs(cfg.n_layers) as qkv:
        for rid, toks in requests:
            sched.submit(rid, toks)
        stats, rec["scheduler_wall_s"] = wall(sched.run_until_drained)
        rec["peak_memory_scheduler_bytes"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        long_out, rec["long_wall_s"] = wall(
            lambda: engine.generate(long_prompt))
    rec["peak_memory_long_bytes"] = torch.cuda.max_memory_allocated()
    rec["launches"] = read_counts(kops)
    rec["flash_launches_by_design"] = dict(by_design)
    # one serve.generate span per engine call: the bucket shape and the
    # prefill (to the first token on the host) and decode walls
    hist = [e for e in RECORDER.events("span")
            if e["name"] == "serve.generate"]
    rec["n_done"] = stats["n_done"]
    rec["p50_latency_s"] = stats["p50_latency_s"]
    rec["p99_latency_s"] = stats["p99_latency_s"]
    rec["buckets"] = [{"batch": h["batch"], "seq": h["seq"],
                       "prefill_s": h["stages"]["prefill"],
                       "decode_steps": h["decode_steps"],
                       "decode_s": h["stages"]["decode"],
                       "decode_tokens_per_s": h["batch"] * h["decode_steps"]
                       / h["stages"]["decode"]} for h in hist]
    short = rec["buckets"][:-1]
    rec["decode_tokens_per_s"] = (
        sum(h["batch"] * h["decode_steps"] for h in short)
        / sum(h["decode_s"] for h in short))
    rec["stats"] = dict(engine.stats)
    check(stats["n_done"] == SERVE_REQUESTS, f"{stats['n_done']} done")
    for rid, _ in requests:
        out = sched.done[rid].output
        check(out.shape == (SERVE_MAX_NEW,) and (out >= 0).all()
              and (out < cfg.vocab).all(), f"{rid}: bad output {out}")
    check(long_out.shape == (1, SERVE_MAX_NEW) and (long_out >= 0).all()
          and (long_out < cfg.vocab).all(), "32k request: bad output")
    check(len(hist) == len(qkv) and hist[-1]["seq"] == LONG_PROMPT,
          f"{len(hist)} generate spans, {len(qkv)} layer-0 inputs kept")
    check(rec["launches"]["flash_attention"] == cfg.n_layers * len(hist),
          f"flash launches {rec['launches']['flash_attention']} != "
          f"{cfg.n_layers} per prefill x {len(hist)} prefills")
    check(by_design["wgmma"] == rec["launches"]["flash_attention"],
          f"the bf16 prefills' flash launches by design: {by_design}")
    for name in PATH_KERNELS["serving"]:
        check(rec["launches"][name] > 0,
              f"kernel {name} never launched on the serving path")

    # the first bucket against the same batch and weights on the CPU:
    # prefill logits in the serving dtype (bf16, SERVE_TOL_BF16), and in
    # f32 (SERVE_TOL) the prefill and SERVE_CHECK_STEPS greedy decode
    # steps, both sides fed the CPU's tokens
    rids, batch = first_bucket(requests, SERVE_MAX_BATCH)
    check(tuple(qkv[0][0].shape[:2]) == batch.shape,
          "the first prefill was not the first bucket")
    bundle = build(cfg)
    first = np.array([sched.done[r].output[0] for r in rids])
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gpu16, _ = greedy_logits(kops, cfg, params, batch, DEV, 0)
    t1 = time.perf_counter()
    cpu_params = weights.from_jax_tree(cfg, tree, device="cpu")
    cpu16, _ = greedy_logits(kops, cfg, cpu_params, batch, "cpu", 0)
    del cpu_params
    rec["cpu_check_bf16_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    cpu_params = weights.from_jax_tree(cfg32, tree, device="cpu")
    cpu32, fed = greedy_logits(kops, cfg32, cpu_params, batch, "cpu",
                               SERVE_CHECK_STEPS)
    del cpu_params
    rec["cpu_check_f32_s"] = time.perf_counter() - t1
    params32 = weights.from_jax_tree(cfg32, tree, device=DEV)
    del tree
    # the f32 checks' flash launches, kept apart from the bf16 counts:
    # every f32 prefill on the card takes the f32 tensor-core design
    f32_flash = {"first_bucket": {}, "ring_check": {}}
    gpu32, _ = greedy_logits(kops, cfg32, params32, batch, DEV,
                             SERVE_CHECK_STEPS, ids=fed,
                             flash=f32_flash["first_bucket"])
    # the 32k request's ring decode, in f32, against a fresh prefill
    t1 = time.perf_counter()
    ring_gap = ring_decode_gap(kops, cfg32, params32, long_prompt,
                               SERVE_MAX_NEW - 1,
                               flash=f32_flash["ring_check"])
    rec["ring_check_s"] = time.perf_counter() - t1
    rec["f32_flash_launches_by_design"] = f32_flash
    del params32
    checks = {}
    for name, gpu, cpu, tol in (("bf16", gpu16, cpu16, SERVE_TOL_BF16),
                                ("f32", gpu32, cpu32, SERVE_TOL)):
        top2 = torch.topk(cpu, 2, dim=-1).values
        decided = (top2[..., 0] - top2[..., 1]) > 2 * tol
        checks[name] = {
            "decode_steps": cpu.shape[0] - 1,
            "max_abs_logit_diff": float((gpu - cpu).abs().max()),
            "tol": tol, "logit_max_abs": float(cpu.abs().max()),
            "tokens_decided": int(decided.sum()),
            "tokens_equal": int((gpu.argmax(-1) == cpu.argmax(-1)).sum()),
            "decided_equal": bool(torch.equal(gpu.argmax(-1)[decided],
                                              cpu.argmax(-1)[decided]))}
    rec["first_bucket_check"] = {
        "batch": list(batch.shape), **checks,
        "bf16_vs_f32_card_max_abs_logit_diff": float(
            (gpu16[0] - gpu32[0]).abs().max())}
    rec["ring_check"] = {"prompt": LONG_PROMPT, "decode_steps":
                         SERVE_MAX_NEW - 1, "dtype": "float32",
                         "max_abs_logit_diff": ring_gap, "tol": SERVE_TOL}
    sq, sk = qkv[0][0].float(), qkv[0][1].float()
    rec["layer0_attention_logit_std"] = float(torch.einsum(
        "bqkgd,bskd->bkgqs", sq.unflatten(2, (cfg.n_kv_heads, -1)), sk).std()
        * cfg.hd ** -0.5)
    emit(rec)
    for name, c in checks.items():
        check(c["max_abs_logit_diff"] <= c["tol"],
              f"first bucket: card vs CPU {name} logits differ by "
              f"{c['max_abs_logit_diff']} > {c['tol']}")
        check(c["decided_equal"], f"first bucket: a decided {name} token "
                                  f"differs between card and CPU")
    check(ring_gap <= SERVE_TOL, f"32k ring decode: logits {ring_gap} "
                                 f"from a prefill of the same tokens")
    # one f32 prefill in the first bucket's check, two in the ring check
    for name, prefills in (("first_bucket", 1), ("ring_check", 2)):
        got = f32_flash[name]
        check(got.get("wgmma_f32") == prefills * cfg.n_layers
              and sum(got.values()) == got["wgmma_f32"],
              f"{name}: f32 flash launches by design {got}, not "
              f"{prefills * cfg.n_layers} on the f32 tensor cores")
    check(np.array_equal(first, gpu16[0].argmax(-1).numpy()),
          "first bucket: the scheduler's first tokens are not the prefill's")
    # where the serving time goes: one bucket's generate (prefill and 16
    # decode steps) and the 32k prefill under torch.profiler, after the
    # counted run
    rec_prof = {"phase": "serving_profile", "gpu": nvidia_smi_line(),
                "bucket": list(batch.shape),
                "generate_first_bucket": device_profile(
                    lambda: engine.generate(batch)),
                "prefill_32k": device_profile(lambda: bundle.prefill(
                    params, {"tokens": torch.as_tensor(long_prompt,
                                                       device=DEV)}))}
    emit(rec_prof)
    del engine, sched, params
    return {"launches": {**rec["launches"], "flash_attention_f32": sum(
        f["wgmma_f32"] for f in f32_flash.values())},
            "long_qkv": qkv[-1], "short_qkv": qkv[0]}


def phase_kernel_serving(bench: KernelBench, merge_out, serving_out) -> None:
    """The serving slice's kernels at the shapes their paths gave them,
    timed: flash attention on layer 0's q/k/v of the 32k prompt (in bf16,
    and the same values in f32, both on the tensor cores) and of the
    first bucket, the masked merge on the head table (in alternating
    rounds with the torch.where pair)."""
    long_qkv = serving_out.pop("long_qkv")
    bench.flash(*long_qkv, main=True, reps=3)
    bench.main["flash_attention"].update(lse_rounds(bench, *long_qkv))
    f32_qkv = tuple(x.float() for x in long_qkv)
    bench.flash(*f32_qkv, main=True, reps=3, name="flash_attention_f32")
    bench.main["flash_attention_f32"].update(lse_rounds(bench, *f32_qkv))
    del long_qkv, f32_qkv
    bench.flash(*serving_out.pop("short_qkv"))
    torch.cuda.empty_cache()
    bench.masked_merge(*merge_out.pop("args"), merge_out["ts_new"],
                       main=True, rounds=TIMED_ROUNDS)


def lse_rounds(bench: KernelBench, q, k, v, rounds: int = 3) -> dict:
    """The forward (any design) with a null lse pointer (serving) and with
    one (training) in alternating rounds of 3 calls each: their medians
    and every round. The output must not change bit for bit, and the lse
    must match the plain version's within LSE_TOL (-1e30 exactly where a
    row sees no key)."""
    from repro_torch.kernels import flash_attention as fa
    o0, _ = fa._forward(q, k, v, lse=False)
    o1, lse = fa._forward(q, k, v, lse=True)
    _, want = bench.kops.ref.ref_flash_attention(
        q, k, v, bq=PLAIN_FLASH_TILE, bk=PLAIN_FLASH_TILE, return_lse=True)
    check(torch.equal(o0, o1), "the lse write changed the flash output")
    seen = want > -1e29
    ok, err = within(lse[seen], want[seen], LSE_TOL)
    check(ok and bool((lse[~seen] == -1e30).all()),
          f"flash lse differs from plain by {err}")
    del o0, o1, lse, want
    null, with_lse = [], []
    for _ in range(rounds):
        null.append(cuda_ms(lambda: fa._forward(q, k, v, lse=False), 3))
        with_lse.append(cuda_ms(lambda: fa._forward(q, k, v, lse=True), 3))
    return {"null_lse_ms": float(np.median(null)),
            "lse_ms": float(np.median(with_lse)),
            "null_lse_rounds_ms": null, "lse_rounds_ms": with_lse,
            "lse_max_abs_diff": err}


def phase_serving_parity(seed: int) -> None:
    """The smoke config, in f32, through device="cpu" and device="cuda":
    the same greedy ids from a Scheduler run and the same prefill logits
    within SMOKE_TOL."""
    from repro_torch.configs import RunConfig, get_smoke_config
    from repro_torch.models import build, weights
    from repro_torch.serve import Scheduler, ServeConfig, ServeEngine
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    tree = weights.random_tree(cfg, np.random.default_rng(seed + 3))
    requests = serving_requests(cfg, seed + 4)
    _, batch = first_bucket(requests, SERVE_MAX_BATCH)
    outs, logits = [], []
    for dev in ("cpu", DEV):
        params = weights.from_jax_tree(cfg, tree, device=dev)
        engine = ServeEngine(cfg, params,
                             ServeConfig(max_new_tokens=SERVE_MAX_NEW),
                             run=RunConfig())
        sched = Scheduler(engine, max_batch=SERVE_MAX_BATCH)
        for rid, toks in requests:
            sched.submit(rid, toks)
        sched.run_until_drained()
        outs.append({r: sched.done[r].output for r, _ in requests})
        logits.append(build(cfg).prefill(params, {"tokens": torch.as_tensor(
            batch, device=dev)})[0].cpu())
    err = float((logits[0] - logits[1]).abs().max())
    same = all(np.array_equal(outs[0][r], outs[1][r]) for r, _ in requests)
    emit({"phase": "serving_parity", "config": cfg.name, "dtype": cfg.dtype,
          "requests": len(requests), "ids_equal": same,
          "max_abs_logit_diff": err, "tol": SMOKE_TOL})
    check(same, "smoke serving: greedy ids differ between cpu and cuda")
    check(err <= SMOKE_TOL, f"smoke serving: logits differ by {err}")


# ---------------------------------------------------------------------------
# the decoder-only model families: Jamba-v0.1 served at its published
# widths, the other new configs one bucket each, the smoke configs in f32
# on the CPU and the card
# ---------------------------------------------------------------------------

#: the served model: Jamba-v0.1 at its published widths (d 4,096, 32 / 8
#: heads of 128, 16 experts top-2 of d_ff 14,336, Mamba state 16, conv 4,
#: expand 2, vocab 65,536), cut to one period of its 1:7 interleave: 8 of
#: 32 layers (attention at 4, MoE at 1, 3, 5 and 7), 13.3 B parameters
#: (26.6 GB in bf16; the whole model's 104 GB does not fit one card)
FAMILY_SERVED = ("jamba-v0.1-52b", 8)
FAMILY_LONG = 4096     # one prompt at batch 1 after the Scheduler's run
FAMILY_DECODE = 8      # decode steps after each other config's prefill
#: every other new config at its published widths, (arch, layers run): all
#: of the dense ones' and rwkv6-7b's, the MoE and VLM giants cut in depth
#: to what one card holds (grok-1 2 of 64, kimi-k2 1 of 61, qwen2-vl 2 of
#: 80)
FAMILY_OTHERS = (("olmo-1b", 16), ("qwen1.5-4b", 40), ("qwen2-0.5b", 24),
                 ("rwkv6-7b", 32), ("grok-1-314b", 2),
                 ("kimi-k2-1t-a32b", 1), ("qwen2-vl-72b", 2))
#: rwkv6-7b's layers under the profiler at FAMILY_LONG tokens: its 32 layers
#: are of one kind, and the profiler's host work grows with the ops (128
#: chunks of 32 tokens a layer); the whole model's would take minutes.
#: Profiles run in a fresh process (:func:`family_profile_fresh`), since
#: the profiler loses device events late in a long one
FAMILY_PROFILE_LAYERS = 2
FAMILY_SMOKE = ("grok-1-314b", "jamba-v0.1-52b", "kimi-k2-1t-a32b",
                "olmo-1b", "qwen1.5-4b", "qwen2-0.5b", "qwen2-vl-72b",
                "rwkv6-7b", "whisper-medium")
#: the device-time regions of one prefill: the Mamba and RWKV scans (the
#: scan kernels' wrappers, as the model modules call them), the MoE's
#: routing, dispatch, expert products and combine (module, function)
FAMILY_REGIONS = {
    "mamba_scan": ("repro_torch.models.ssm", "ssm_scan"),
    "rwkv_scan": ("repro_torch.models.rwkv", "wkv"),
    "moe_route": ("repro_torch.models.moe", "route"),
    "moe_dispatch": ("repro_torch.models.moe", "dispatch"),
    "moe_experts": ("repro_torch.models.moe", "expert_ffn"),
    "moe_combine": ("repro_torch.models.moe", "combine"),
}
#: the scan regions' kernels by name: the profiler records a kernel that
#: the port's libraries launch (through ctypes), but need not tie it to
#: the host range that launched it, so the regions' kernel time is also
#: read by name (``kernel_device_s``)
FAMILY_REGION_KERNELS = {"mamba_scan": "ssm_scan_kernel",
                         "rwkv_scan": "wkv_kernel"}


#: families_train: kimi-k2 trained on one card at its published widths,
#: cut to FT_LAYERS of its 61 layers and FT_EXPERTS of its 384 experts (one
#: layer's 384 experts alone are 16.9 B parameters, 33.8 GB in bf16 before
#: the embedding, the head and any gradient: the step does not fit 80 GB;
#: at 64 experts the model is 5.3 B), Adafactor (the config's
#: recommendation), B 1 x S 4,096 (chunked by the launcher's rule), 3 steps
FT_ARCH, FT_LAYERS, FT_EXPERTS = "kimi-k2-1t-a32b", 1, 64
FT_BATCH, FT_SEQ, FT_STEPS = 1, 4096, 3
#: the smoke configs' training step, CPU against the card: B x S tokens,
#: S ragged over the mma kernels' 16-row strips and 32-row tiles
FT_SMOKE_BATCH, FT_SMOKE_SEQ = 2, 100


def family_cfg(arch: str, layers: int):
    """The arch's published config, ``layers`` deep, in bf16."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), n_layers=layers)


def _leaves_of(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
        return
    for v in (tree.values() if isinstance(tree, dict) else tree):
        yield from _leaves_of(v)


def tree_sizes(params) -> tuple[int, int]:
    """(elements, bytes) of a parameter tree."""
    leaves = list(_leaves_of(params))
    return (sum(t.numel() for t in leaves),
            sum(t.numel() * t.element_size() for t in leaves))


def flash_key(cfg) -> str:
    """The design and head dim a config's prefill attention takes."""
    from repro_torch.kernels import flash_attention as fa
    return f"{fa.design(getattr(torch, cfg.dtype), cfg.hd)}<{cfg.hd}>"


def peak_bytes() -> int:
    return torch.cuda.max_memory_allocated()


def reset_peak() -> None:
    sync()
    torch.cuda.reset_peak_memory_stats()


@contextlib.contextmanager
def flash_calls(keep: int = 0):
    """Count the attention module's flash calls on the card by design and
    head dim (``"wgmma<128>"``; each launches one kernel) and keep the
    q, k, v of the first ``keep`` calls and of the last one (``"qkv"``,
    ``"last_qkv"``)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as A
    orig, out = A.flash_attention, {"by_dim": {}, "qkv": []}

    def wrapped(q, k, v):
        if q.device.type == torch.device(DEV).type:
            key = f"{fa.design(q.dtype, q.shape[3])}<{q.shape[3]}>"
            out["by_dim"][key] = out["by_dim"].get(key, 0) + 1
            if len(out["qkv"]) < keep:
                out["qkv"].append((q, k, v))
            out["last_qkv"] = (q, k, v)
        return orig(q, k, v)

    A.flash_attention = wrapped
    try:
        yield out
    finally:
        A.flash_attention = orig


@contextlib.contextmanager
def labelled_regions(regions: dict):
    """Wrap each region's function in a ``torch.profiler.record_function``
    of its label and a pair of CUDA events; yields {label: [event pairs]}."""
    import importlib
    spans, patched = {k: [] for k in regions}, []
    for label, (mod_name, fn_name) in regions.items():
        mod = importlib.import_module(mod_name)
        orig = getattr(mod, fn_name)

        def wrapped(*a, _orig=orig, _label=label, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            with torch.profiler.record_function(_label):
                ev[0].record()
                out = _orig(*a, **kw)
                ev[1].record()
            spans[_label].append(ev)
            return out

        setattr(mod, fn_name, wrapped)
        patched.append((mod, fn_name, orig))
    try:
        yield spans
    finally:
        for mod, fn_name, orig in patched:
            setattr(mod, fn_name, orig)


def _dev_us(e, attr: str) -> float:
    v = getattr(e, attr.replace("cuda", "device"), None)
    return float(v if v is not None else getattr(e, attr, 0) or 0)


def region_shares(fn, regions: dict, kernels: dict | None = None) -> dict:
    """One run of ``fn`` under torch.profiler with each region labelled:
    the device time of every kernel and copy the profiler kept
    (``device_s``), and per region its kernels' device time (the kernels
    its host range launched, ``region_device_s``) and that over
    ``device_s`` (``share``); beside them each region's summed CUDA-event
    spans on the stream (``region_span_s``: an upper bound, the spans also
    hold the card's waits on the host inside the region).

    ``kernels`` ({label: a kernel name}): the device time of the kept
    kernels whose name holds it (``kernel_device_s``) and its share of
    ``device_s`` (``kernel_share``), for kernels that the port launches
    through ctypes. ``top_ms``: the six kernels (by name, first 80
    characters) with the most device time, in ms.

    Where the profiler lost events (``complete`` false) no share is read:
    the kept events are then not only fewer but can be misattributed (a
    region's kept kernel time has passed its own span)."""
    from torch.profiler import ProfilerActivity, profile
    with labelled_regions(regions) as spans:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, s = wall(fn)
    evs = prof.events()
    labels = set(regions)
    dev = [e for e in evs if "CUDA" in str(e.device_type)
           and e.name not in labels]
    total = sum(_dev_us(e, "self_cuda_time_total") for e in dev) / 1e6
    by = dict.fromkeys(labels, 0.0)
    for e in evs:
        if e.name in labels and "CPU" in str(e.device_type):
            by[e.name] += _dev_us(e, "cuda_time_total") / 1e6
    enqueued = sum("CPU" in str(e.device_type)
                   and bool(ENQUEUE_CALL.match(e.name)) for e in evs)
    span_s = {k: sum(a.elapsed_time(b) for a, b in v) / 1e3
              for k, v in spans.items()}
    by_name = {k: sum(_dev_us(e, "self_cuda_time_total") for e in dev
                      if name in e.name) / 1e6
               for k, name in (kernels or {}).items()}
    per_kernel: dict = {}
    for e in dev:
        key = e.name[:80]
        per_kernel[key] = (per_kernel.get(key, 0.0)
                           + _dev_us(e, "self_cuda_time_total") / 1e3)
    return {"wall_s": s, "device_s": total, "idle_share":
            1 - total / s if s > 0 else None,
            "complete": len(dev) >= enqueued, "calls": {
                k: len(v) for k, v in spans.items()},
            "region_device_s": by,
            "share": {k: (v / total if total > 0 else None)
                      for k, v in by.items()},
            "region_span_s": span_s,
            "span_share": {k: (v / s if s > 0 else None)
                           for k, v in span_s.items()},
            "kernel_device_s": by_name,
            "kernel_share": {k: (v / total if total > 0 else None)
                             for k, v in by_name.items()},
            "top_ms": sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]}


def vlm_inputs(cfg, b: int, s: int, gen, dtype) -> dict:
    """Stand-ins for qwen2-vl's stubbed vision frontend (``batch_specs``):
    (B, S, d) embeddings from ``gen`` and M-RoPE's (3, B, S) positions,
    temporal 0 .. S-1, height and width a 4-wide patch grid."""
    t = torch.arange(s, device=gen.device)
    pos = torch.stack([t, t // 4, t % 4]).to(torch.int32)
    return {"embeds": torch.randn(b, s, cfg.d_model, generator=gen,
                                  device=gen.device).to(dtype),
            "positions": pos[:, None, :].expand(3, b, s).contiguous()}


def vlm_step_positions(b: int, s: int, t: int, device) -> torch.Tensor:
    """The (3, B, 1) M-RoPE positions of decode step ``t`` after an
    S-token prompt: past the patch grid, all three rows advance."""
    p = s // 4 + t
    return torch.tensor([s + t, p, p], dtype=torch.int32,
                        device=device)[:, None, None].expand(3, b, 1)


def family_one_bucket(kops, cfg, seed: int, profile_layers: int = 0) -> dict:
    """One bucket of the serving stream through ``cfg`` at its published
    widths on the card: the prefill, then FAMILY_DECODE greedy decode
    steps (qwen2-vl through ModelBundle with embeddings and M-RoPE
    positions), with walls, peak memory and flash calls by design and
    head dim, and the scan kernels' launches (one a Mamba or RWKV layer a
    prefill or decode step, checked); with ``profile_layers``, a
    FAMILY_LONG-token prompt at batch 1 (as Jamba's): one prefill for its
    wall (its scan inputs of the first scan layer kept, ``scan_inputs``),
    then :func:`family_profile_fresh` of the first ``profile_layers``
    layers. The model is freed after."""
    from repro_torch.models import build, transformer
    bundle = build(cfg)
    reset_peak()
    params, init_s = wall(lambda: bundle.init(seed, device=DEV))
    kinds = transformer.layer_kinds(cfg)
    rec = {"layers": cfg.n_layers, "d_model": cfg.d_model,
           "head_dim": cfg.hd, "heads": [cfg.n_heads, cfg.n_kv_heads],
           "init_s": init_s,
           "kinds": sorted({f"{m}+{f}" for m, f in kinds})}
    rec["params"], rec["weights_bytes"] = tree_sizes(params)
    _, batch = first_bucket(serving_requests(cfg, seed), SERVE_MAX_BATCH)
    b, s = batch.shape
    if cfg.input_mode == "embeddings":
        gen = torch.Generator(device=DEV).manual_seed(seed)
        inp = vlm_inputs(cfg, b, s, gen, getattr(torch, cfg.dtype))
    else:
        inp = {"tokens": torch.as_tensor(batch, device=DEV)}
    reset_counts(kops)
    with flash_calls() as calls, scan_calls(FAMILY_LONG) as scans:
        (logits, state), rec["prefill_s"] = wall(lambda: bundle.prefill(
            params, inp, pad_to=s + FAMILY_DECODE))
        first = logits

        def decode():
            nonlocal logits, state
            for t in range(FAMILY_DECODE):
                tok = logits[:, 0].argmax(-1, keepdim=True)
                pos = (vlm_step_positions(b, s, t, DEV)
                       if cfg.mrope_sections else None)
                logits, state = bundle.decode(params, tok, state, pos)
        _, rec["decode_s"] = wall(decode)
    rec["bucket"] = [b, s]
    rec["decode_tokens_per_s"] = b * FAMILY_DECODE / rec["decode_s"]
    rec["peak_memory_bytes"] = peak_bytes()
    rec["flash_calls_by_dim"] = calls["by_dim"]
    rec["launches"] = {k: v for k, v in read_counts(kops).items() if v}
    n_attn = sum(m == "attn" for m, _ in kinds)
    check(bool(torch.isfinite(first).all() and torch.isfinite(logits).all())
          and logits.shape == (b, 1, cfg.vocab),
          f"{cfg.name}: logits not finite or of shape {logits.shape}")
    want = {flash_key(cfg): n_attn} if n_attn else {}
    check(calls["by_dim"] == want and rec["launches"].get(
        "flash_attention", 0) == n_attn,
          f"{cfg.name}: flash calls {calls['by_dim']}, launches "
          f"{rec['launches']}, not {want}")
    rec["last_qkv_shape"] = (list(calls["last_qkv"][0].shape)
                             if n_attn else None)
    per_pass = {"ssm_scan": sum(m == "mamba" for m, _ in kinds),
                "wkv": sum(m == "rwkv" for m, _ in kinds)}
    passes = 1 + FAMILY_DECODE
    rec["scan_launches"] = {k: read_counts(kops)[k] for k in per_pass}
    check(all(rec["scan_launches"][k] == scans[k] == n * passes
              for k, n in per_pass.items()),
          f"{cfg.name}: scan launches {rec['scan_launches']}, calls "
          f"{scans}, not {passes} passes of {per_pass}")
    del state, logits, first, calls
    if profile_layers:
        long_inp = long_prompt_batch(cfg, seed)
        reset_peak()
        with scan_calls(FAMILY_LONG) as scans:
            _, rec["long_prefill_s"] = wall(
                lambda: bundle.prefill(params, long_inp))
        rec["peak_memory_long_bytes"] = peak_bytes()
        passes += 1
        rec["scan_launches"] = {k: read_counts(kops)[k] for k in per_pass}
        check(all(rec["scan_launches"][k] == n * passes
                  for k, n in per_pass.items()),
              f"{cfg.name}: scan launches {rec['scan_launches']} after "
              f"the long prefill, not {passes} passes of {per_pass}")
        rec["scan_inputs"] = scans["kept"]
        if per_pass["wkv"]:
            r = scans["kept"]["wkv"][0]
            check(tuple(r.shape) == (1, FAMILY_LONG, cfg.n_heads,
                                     cfg.d_model // cfg.n_heads),
                  f"{cfg.name}: the long prompt's r is {tuple(r.shape)}")
    del params, inp
    torch.cuda.empty_cache()
    if profile_layers:
        rec["profile_long_prefill"] = family_profile_fresh(
            cfg.name, profile_layers, seed)
    return rec


def long_prompt_batch(cfg, seed: int) -> dict:
    """A FAMILY_LONG-token prompt at batch 1 on the card (the tokens of
    :func:`phase_families`' long request)."""
    return {"tokens": torch.as_tensor(np.random.default_rng(seed + 5).integers(
        3, cfg.vocab, (1, FAMILY_LONG)), device=DEV)}


def family_profile_child(arch: str, layers: int, seed: int) -> None:
    """In a fresh process: ``arch`` at its published widths, ``layers``
    deep, seeded weights on the card; one warm-up prefill of the
    FAMILY_LONG-token prompt, then one under :func:`region_shares`,
    printed as the last line."""
    from repro_torch.models import build
    cfg = family_cfg(arch, layers)
    bundle = build(cfg)
    params = bundle.init(seed, device=DEV)
    inp = long_prompt_batch(cfg, seed)
    _, warm_s = wall(lambda: bundle.prefill(params, inp))
    out = region_shares(lambda: bundle.prefill(params, inp), FAMILY_REGIONS,
                        FAMILY_REGION_KERNELS)
    print(json.dumps({"layers": layers, "warm_prefill_s": warm_s, **out}),
          flush=True)


def family_profile_fresh(arch: str, layers: int, seed: int) -> dict:
    """:func:`family_profile_child` in a process of its own
    (:func:`fresh_process`)."""
    return fresh_process(f"family_profile_child({arch!r}, {layers}, {seed})")


def family_smoke_parity(kops, cfg, seed: int, keep: int = 0) -> dict:
    """A smoke config in f32 through device="cpu" and device="cuda": the
    same greedy ids from a Scheduler run (qwen2-vl, on embeddings, and
    whisper, on audio frames beside its prompt: from FAMILY_DECODE greedy
    steps through ModelBundle) and the same prefill
    logits within SMOKE_TOL; the card run's kernel launches (the counts
    set to 0 just before it) and flash launches by design, its flash calls
    by design and head dim (which must add up to those launches, design
    by design), and the q, k, v of its first ``keep`` calls."""
    from repro_torch.configs import RunConfig
    from repro_torch.models import build, weights
    from repro_torch.serve import Scheduler, ServeConfig, ServeEngine
    tree = weights.random_tree(cfg, np.random.default_rng(seed))
    bundle = build(cfg)
    requests = serving_requests(cfg, seed + 1)
    _, batch = first_bucket(requests, SERVE_MAX_BATCH)
    outs, logits, calls = [], [], None
    for dev in ("cpu", DEV):
        params = weights.from_jax_tree(cfg, tree, device=dev)
        counted = (flash_calls(keep) if dev == DEV
                   else contextlib.nullcontext())
        if dev == DEV:
            reset_counts(kops)
        with counted as got:
            if cfg.input_mode == "embeddings" or cfg.family == "encdec":
                if cfg.family == "encdec":
                    inp = {"enc_embeds": whisper_frames(
                        cfg, batch.shape[0], seed, dev, torch.float32),
                        "tokens": torch.as_tensor(batch, device=dev)}
                else:
                    gen = torch.Generator().manual_seed(seed)
                    inp = {k: v.to(dev) for k, v in vlm_inputs(
                        cfg, *batch.shape, gen, torch.float32).items()}
                lg, state = bundle.prefill(params, inp,
                                           pad_to=batch.shape[1]
                                           + FAMILY_DECODE)
                ids = []
                for t in range(FAMILY_DECODE):
                    ids.append(lg[:, 0].argmax(-1, keepdim=True))
                    lg, state = (
                        bundle.decode(params, ids[-1], state)
                        if cfg.family == "encdec" else
                        bundle.decode(params, ids[-1], state,
                                      vlm_step_positions(*batch.shape, t,
                                                         dev)))
                outs.append({"greedy": torch.cat(ids, 1).cpu().numpy()})
                logits.append(bundle.prefill(params, inp)[0].cpu())
            else:
                engine = ServeEngine(cfg, params, ServeConfig(
                    max_new_tokens=SERVE_MAX_NEW), run=RunConfig())
                sched = Scheduler(engine, max_batch=SERVE_MAX_BATCH)
                for rid, toks in requests:
                    sched.submit(rid, toks)
                sched.run_until_drained()
                outs.append({r: sched.done[r].output for r, _ in requests})
                logits.append(bundle.prefill(params, {
                    "tokens": torch.as_tensor(batch, device=dev)})[0].cpu())
        if dev == DEV:
            calls = got
            launches = {k: v for k, v in read_counts(kops).items() if v}
            by_design = {k: v for k, v in
                         kops.flash_attention.by_design.items() if v}
    err = float((logits[0] - logits[1]).abs().max())
    same = all(np.array_equal(outs[0][r], outs[1][r]) for r in outs[0])
    from_calls: dict = {}
    for key, n in calls["by_dim"].items():
        d = key.split("<")[0]
        from_calls[d] = from_calls.get(d, 0) + n
    check(from_calls == by_design and sum(by_design.values())
          == launches.get("flash_attention", 0),
          f"{cfg.name} smoke f32: flash calls {calls['by_dim']} against "
          f"launches {launches}, by design {by_design}")
    return {"config": cfg.name, "ids_equal": same, "sequences": len(outs[0]),
            "max_abs_logit_diff": err, "tol": SMOKE_TOL,
            "launches": launches, "flash_launches_by_design": by_design,
            "flash_calls_by_dim": calls["by_dim"], "qkv": calls["qkv"]}


def phase_families(kops, seed: int) -> dict:
    """The decoder-only families on the card. Jamba-v0.1 at its published
    widths (FAMILY_SERVED's depth) through Scheduler and ServeEngine with
    the serving phase's requests and SERVE_MAX_NEW tokens, then one
    FAMILY_LONG-token prompt at batch 1: Mamba, MoE and bf16 flash at D
    128 on one path; one profiled prefill of that prompt and of rwkv6-7b's
    FAMILY_LONG-token prompt (FAMILY_PROFILE_LAYERS deep) with the scans'
    and the MoE's share of the device time; the scan kernel's launches one
    a Mamba layer each prefill and decode step, and the scan inputs of the
    long prefill's first Mamba layer kept (``ssm_scan_inputs``). Then
    every other new config (FAMILY_OTHERS) for one bucket (rwkv6-7b's WKV
    launches checked the same way, its long prefill's layer-0 inputs kept:
    ``wkv_inputs``); then the smoke configs in f32 on the CPU and the
    card, their flash and scan launches counted on the card run."""
    from repro_torch.configs import RunConfig, get_config, get_smoke_config
    from repro_torch.models import build, transformer
    from repro_torch.obs.recorder import RECORDER
    from repro_torch.serve import Scheduler, ServeConfig, ServeEngine
    arch, layers = FAMILY_SERVED
    cfg = family_cfg(arch, layers)
    kinds = transformer.layer_kinds(cfg)
    n_attn = sum(m == "attn" for m, _ in kinds)
    served = {"arch": arch, "layers": layers, "d_model": cfg.d_model,
              "kinds": [f"{m}+{f}" for m, f in kinds], "dtype": cfg.dtype,
              "reduced": {"layers": f"{layers} of 32: one period of the "
                          "1:7 interleave (the whole model, 104 GB in "
                          "bf16, does not fit one card)"}}
    bundle = build(cfg)
    reset_peak()
    params, served["init_s"] = wall(lambda: bundle.init(seed, device=DEV))
    served["params"], served["weights_bytes"] = tree_sizes(params)
    engine = ServeEngine(cfg, params,
                         ServeConfig(max_new_tokens=SERVE_MAX_NEW),
                         run=RunConfig())
    sched = Scheduler(engine, max_batch=SERVE_MAX_BATCH)
    requests = serving_requests(cfg, seed)
    long_prompt = np.random.default_rng(seed + 5).integers(
        3, cfg.vocab, (1, FAMILY_LONG)).astype(np.int32)
    RECORDER.clear()
    reset_counts(kops)
    with flash_calls() as calls, scan_calls(FAMILY_LONG) as scans:
        for rid, toks in requests:
            sched.submit(rid, toks)
        stats, served["scheduler_wall_s"] = wall(sched.run_until_drained)
        served["peak_memory_scheduler_bytes"] = peak_bytes()
        reset_peak()
        long_out, served["long_wall_s"] = wall(
            lambda: engine.generate(long_prompt))
    served["peak_memory_long_bytes"] = peak_bytes()
    served["launches"] = read_counts(kops)
    served["flash_launches_by_design"] = dict(kops.flash_attention.by_design)
    served["flash_calls_by_dim"] = dict(calls["by_dim"])
    hist = [e for e in RECORDER.events("span")
            if e["name"] == "serve.generate"]
    served["n_done"] = stats["n_done"]
    served["p50_latency_s"] = stats["p50_latency_s"]
    served["p99_latency_s"] = stats["p99_latency_s"]
    served["buckets"] = [{"batch": h["batch"], "seq": h["seq"],
                          "prefill_s": h["stages"]["prefill"],
                          "decode_steps": h["decode_steps"],
                          "decode_s": h["stages"]["decode"]} for h in hist]
    short = served["buckets"][:-1]
    served["decode_tokens_per_s"] = (
        sum(h["batch"] * h["decode_steps"] for h in short)
        / sum(h["decode_s"] for h in short))
    served["long_prefill_s"] = served["buckets"][-1]["prefill_s"]
    check(stats["n_done"] == SERVE_REQUESTS, f"{stats['n_done']} done")
    for rid, _ in requests:
        out = sched.done[rid].output
        check(out.shape == (SERVE_MAX_NEW,) and (out >= 0).all()
              and (out < cfg.vocab).all(), f"{rid}: bad output {out}")
    check(long_out.shape == (1, SERVE_MAX_NEW) and (long_out >= 0).all()
          and (long_out < cfg.vocab).all(), "the long request: bad output")
    check(len(hist) >= 2 and hist[-1]["seq"] == FAMILY_LONG,
          f"{len(hist)} generate spans")
    n_flash = served["launches"]["flash_attention"]
    check(n_flash == n_attn * len(hist) and n_flash > 0
          and served["flash_launches_by_design"][
              flash_key(cfg).split("<")[0]] == n_flash
          and calls["by_dim"] == {flash_key(cfg): n_flash},
          f"jamba flash launches {n_flash}, by design "
          f"{served['flash_launches_by_design']}, by dim {calls['by_dim']}")
    long_qkv = calls["last_qkv"]
    check(tuple(long_qkv[0].shape) == (1, FAMILY_LONG, cfg.n_heads, cfg.hd),
          f"the long prompt's q is {tuple(long_qkv[0].shape)}")
    # the scan kernel: one launch a Mamba layer each prefill and decode
    # step (every generate span: a prefill, then its decode steps)
    n_mamba = sum(m == "mamba" for m, _ in kinds)
    passes = len(hist) + sum(h["decode_steps"] for h in hist)
    n_scan = served["launches"]["ssm_scan"]
    served["ssm_scan_passes"] = passes
    check(n_scan == n_mamba * passes == scans["ssm_scan"]
          and served["launches"]["wkv"] == 0,
          f"jamba ssm_scan launches {n_scan} (calls {scans['ssm_scan']}), "
          f"not {n_mamba} x {passes} prefills and decode steps")
    ssm_inputs = scans["kept"]["ssm_scan"]
    check(tuple(ssm_inputs[0].shape) == (1, FAMILY_LONG,
                                         cfg.ssm_expand * cfg.d_model),
          f"the long prompt's dt is {tuple(ssm_inputs[0].shape)}")
    del calls, scans, engine, sched, params
    torch.cuda.empty_cache()
    # where the device time of one long prefill goes: the Mamba scan, the
    # MoE's steps, the rest (the same weights and prompt, profiled in a
    # process of its own)
    served["profile_long_prefill"] = family_profile_fresh(arch, layers, seed)
    rec = {"phase": "families", "gpu": nvidia_smi_line(), "served": {
        k: served[k] for k in ("arch", "layers", "scheduler_wall_s",
                               "long_prefill_s", "decode_tokens_per_s",
                               "peak_memory_long_bytes",
                               "flash_calls_by_dim")}}
    emit({"phase": "families_served", **served})
    # -- every other new config, one bucket each -------------------------
    others, launches = {}, {"flash_attention_d112": 0}
    for i, (name, depth) in enumerate(FAMILY_OTHERS):
        one = family_one_bucket(
            kops, family_cfg(name, depth), seed + 10 + i,
            FAMILY_PROFILE_LAYERS if name == "rwkv6-7b" else 0)
        scan_kept = one.pop("scan_inputs", {})
        if "wkv" in scan_kept:
            wkv_inputs = scan_kept["wkv"]
            launches["wkv"] = one["scan_launches"]["wkv"]
        others[name] = one
        launches["flash_attention_d112"] += one["flash_calls_by_dim"].get(
            "wgmma<112>", 0)
        full = get_config(name).n_layers
        emit({"phase": "families_config", "arch": name, "reduced": (
            None if depth == full else f"{depth} of {full} layers"), **one})
    rec["others"] = {k: {x: v[x] for x in (
        "layers", "prefill_s", "decode_tokens_per_s", "peak_memory_bytes",
        "flash_calls_by_dim", "scan_launches")} for k, v in others.items()}
    check("wkv" in launches, "rwkv6-7b: no long prefill's WKV inputs")
    # -- the eight smoke configs in f32, CPU against the card ------------
    smoke, kept = {}, {}
    for i, name in enumerate(FAMILY_SMOKE):
        c = dataclasses.replace(get_smoke_config(name), dtype="float32")
        one = family_smoke_parity(kops, c, seed + 40 + i,
                                  keep=1 if c.hd == 8 else 0)
        if one["qkv"]:
            kept["d8_f32"] = one["qkv"][0]
        one.pop("qkv")
        smoke[name] = one
    rec["smoke_f32"] = smoke
    by_dim: dict = {}
    for one in smoke.values():      # launches, split by head dim
        for k, v in one["flash_calls_by_dim"].items():
            by_dim[k] = by_dim.get(k, 0) + v
    rec["smoke_f32_flash_calls_by_dim"] = by_dim
    rec["smoke_f32_flash_launches"] = sum(
        one["launches"].get("flash_attention", 0) for one in smoke.values())
    # the f32 smoke checks of jamba and rwkv6 run the scan kernels (one
    # launch a scan layer a pass); no other config launches one
    rec["smoke_f32_scan_launches"] = {
        name: {k: one["launches"].get(k, 0) for k in ("ssm_scan", "wkv")}
        for name, one in smoke.items()}
    rec["served"]["ssm_scan_launches"] = n_scan
    rec["served"]["ssm_scan_passes"] = passes
    emit(rec)
    for name, one in rec["smoke_f32_scan_launches"].items():
        c = get_smoke_config(name)
        per = {"ssm_scan": 0, "wkv": 0}
        if c.family != "encdec":
            per = {"ssm_scan": sum(m == "mamba" for m, _ in
                                   transformer.layer_kinds(c)),
                   "wkv": sum(m == "rwkv" for m, _ in
                              transformer.layer_kinds(c))}
        check(all((one[k] > 0 and one[k] % n == 0) if n else one[k] == 0
                  for k, n in per.items()),
              f"{name} smoke f32: scan launches {one}, layers {per}")
    for name, one in smoke.items():
        check(one["ids_equal"], f"{name} smoke f32: greedy ids differ "
                                f"between cpu and cuda")
        check(one["max_abs_logit_diff"] <= SMOKE_TOL,
              f"{name} smoke f32: logits differ by "
              f"{one['max_abs_logit_diff']}")
    check(by_dim.get("mma_f32<8>", 0) > 0 and by_dim.get("mma_f32<16>", 0)
          > 0 and set(by_dim) == {"mma_f32<8>", "mma_f32<16>"},
          f"smoke f32 flash calls by design and dim: {by_dim}")
    check(launches["flash_attention_d112"] > 0, "kimi-k2: no D 112 launch")
    launches.update({
        "flash_attention_d128_4k": n_flash,
        "flash_attention_d8_f32": by_dim["mma_f32<8>"],
        "flash_attention_d16_f32": by_dim["mma_f32<16>"],
        "flash_attention_d8": 0, "ssm_scan": n_scan})
    for k in PATH_KERNELS["families"]:
        check(served["launches"][k] > 0 or launches.get(k, 0) > 0,
              f"families: no {k} launch")
    return {"launches": launches, "long_qkv": long_qkv,
            "ssm_scan_inputs": ssm_inputs, "wkv_inputs": wkv_inputs, **kept}


def phase_kernel_families(bench: KernelBench, families_out, seed: int) -> None:
    """Flash attention at the families' shapes, each against its plain
    version and SDPA: bf16 D 128 on layer 4's q, k, v of Jamba's
    FAMILY_LONG-token prefill (B 1, H 32 / K 8); bf16 D 112 at kimi-k2's
    attention, B 1 x S FAMILY_LONG, H 64 / K 8, from the seed; D 8 on
    qwen2-0.5b-smoke's first f32 prefill on the card (B 8 x S 16, H 7 /
    K 1; the mma_f32 design), and the same values in bf16 (the mma
    design, on no path)."""
    q, k, v = families_out.pop("long_qkv")
    bench.flash(q, k, v, main=True, name="flash_attention_d128_4k",
                rounds=3, device=True)
    del q, k, v
    gen = torch.Generator(device=DEV).manual_seed(seed + 23)
    q, k, v = (torch.randn(1, FAMILY_LONG, h, 112, generator=gen,
                           device=DEV).to(torch.bfloat16) for h in (64, 8, 8))
    bench.flash(q, k, v, main=True, name="flash_attention_d112", rounds=3,
                device=True)
    del q, k, v
    q, k, v = families_out.pop("d8_f32")
    bench.flash(q, k, v, main=True, name="flash_attention_d8_f32",
                rounds=TIMED_ROUNDS, device=True)
    bench.flash(*(x.to(torch.bfloat16) for x in (q, k, v)), main=True,
                name="flash_attention_d8", rounds=TIMED_ROUNDS, device=True)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the scan kernels: Mamba's selective scan and RWKV6's WKV recurrence
# ---------------------------------------------------------------------------

SCAN_EDGE_L = (1, 2, 127, 128, 129, 1000)  # on and off the 32-step tiles
SCAN_EDGE_B = (1, 3)
SSM_EDGE_DI = 200  # six of the kernel's 32-channel blocks and a ragged one
WKV_EDGE_HEADS = {16: 5, 64: 3}
#: k and v's scale in the WKV edge cases (r unit normal): o sums Dk
#: products r_i S_ij, and where they cancel, two f32 orders of that sum
#: part by more than SCAN_TOL's atol at unit scale (the card read 2.2e-5
#: on o of size 8 at logw's fast end, Dk 64, over 576,000 outputs); at
#: 0.5, o is about unit size
WKV_EDGE_SCALE = 0.5
#: the same where the decay is at the slow end of its clip: S then sums
#: about L outer products, and over 1,000 steps the rounding of each step
#: compounds, so two f32 orders part further. Both ends of the clip also
#: run at unit scale, held against f64
WKV_SLOW_SCALE = 0.02


@contextlib.contextmanager
def scan_calls(keep_len: int):
    """Count the model modules' calls of the scan wrappers on the card
    (``models.ssm.ssm_scan``, ``models.rwkv.wkv``) and keep the inputs of
    the first call of each over ``keep_len`` tokens at batch 1 (the first
    scan layer of a long prompt's prefill): {"ssm_scan": calls, "wkv":
    calls, "kept": {name: args}}."""
    from repro_torch.models import rwkv, ssm
    out, patched = {"ssm_scan": 0, "wkv": 0, "kept": {}}, []
    for mod, name in ((ssm, "ssm_scan"), (rwkv, "wkv")):
        orig = getattr(mod, name)

        def wrapped(*a, _orig=orig, _name=name, **kw):
            if a[0].device.type == torch.device(DEV).type:
                out[_name] += 1
                if (tuple(a[0].shape[:2]) == (1, keep_len)
                        and _name not in out["kept"]):
                    out["kept"][_name] = tuple(a)
            return _orig(*a, **kw)

        setattr(mod, name, wrapped)
        patched.append((mod, name, orig))
    try:
        yield out
    finally:
        for mod, name, orig in patched:
            setattr(mod, name, orig)


def ssm_edge_inputs(gen, b: int, l: int, n: int, x_dtype, *,
                    underflow: bool = False, strided: bool = False):
    """The selective scan's inputs on the card from ``gen``: dt in the
    model's softplus range, A = -(exp(.) + 1), x in ``x_dtype``, B and C
    (where ``strided``, views of one (B, L, 3 + 2N) product, as the f32
    model's split leaves them), a nonzero h0. ``underflow``: dt from 4 to
    6 against |A| over 30, so that every decay exp(dt A) is under e^-120
    and underflows to 0 in f32, x at half scale."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=DEV)
    di = SSM_EDGE_DI
    if underflow:
        dt = 4 + 2 * torch.rand(b, l, di, generator=gen, device=DEV)
        a = -(torch.exp(0.3 * randn(di, n)) + 30)
    else:
        dt = torch.nn.functional.softplus(randn(b, l, di) - 1)
        a = -(torch.exp(0.3 * randn(di, n)) + 1)
    _, bm, cm = torch.split(randn(b, l, 3 + 2 * n), [3, n, n], dim=-1)
    if not strided:
        bm, cm = bm.contiguous(), cm.contiguous()
    x = ((0.5 if underflow else 1.0) * randn(b, l, di)).to(x_dtype)
    return dt, bm, cm, x, a, 0.5 * randn(b, di, n)


def wkv_edge_inputs(gen, b: int, l: int, dk: int, logw=None,
                    scale: float = WKV_EDGE_SCALE):
    """The WKV recurrence's inputs on the card from ``gen``: r unit
    normal, k, v and S_0 at ``scale``, u at half scale; logw as the
    model's decay draws it (-exp of a unit normal clipped to [-8, 4]), or
    the constant ``logw``."""
    h = WKV_EDGE_HEADS[dk]

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=DEV)
    lw = (-torch.exp(randn(b, l, h, dk).clamp(-8.0, 4.0)) if logw is None
          else torch.full((b, l, h, dk), logw, device=DEV))
    return (randn(b, l, h, dk), scale * randn(b, l, h, dk),
            scale * randn(b, l, h, dk), lw, 0.5 * randn(h, dk),
            0.5 * scale * randn(b, h, dk, dk))


def scan_f64(kernel, plain, seq, args) -> dict:
    """A scan kernel and its plain chunked version, each held against the
    sequential plain version in f64 on the same inputs, output by output
    (y or o, then the last state): each one's largest error, and whether
    the kernel's is at most SCAN_F64_FACTOR times the plain version's or
    within SCAN_TOL of f64. Over a long prompt both drift from the exact
    value, so the kernel against the plain version alone cannot say which
    one drifted."""
    want = seq(*(t.double() for t in args))
    got, base = kernel(*args), plain(*args)
    sync()
    out = {"kernel_err": [], "plain_err": [], "kernel_within_tol": []}
    for g, p, w in zip(got, base, want):
        out["kernel_err"].append(float((g.double() - w).abs().max()))
        out["plain_err"].append(float((p.double() - w).abs().max()))
        out["kernel_within_tol"].append(bool(
            ((g.double() - w).abs()
             <= SCAN_TOL[0] + SCAN_TOL[1] * w.abs()).all()))
    out["ok"] = all(k <= SCAN_F64_FACTOR * p or within for k, p, within in
                    zip(out["kernel_err"], out["plain_err"],
                        out["kernel_within_tol"]))
    del want, got, base
    return out


def phase_kernel_edges_scans(bench: KernelBench, seed: int) -> None:
    """Both scan kernels against their plain versions on the card within
    SCAN_TOL: L 1, 2, 127, 128, 129 and 1,000 (the 32-step tiles' edges)
    at B 1 and 3, from a nonzero state. The selective scan at N 8 and 16
    with x in f32 and bf16, d_inner SSM_EDGE_DI (a ragged channel block),
    B and C strided in every other case, and at every (N, x) a case whose
    decays all underflow to 0; the WKV recurrence at Dk 16 and 64 with
    the model's decays, and with logw at both ends of its clip (-e^4, a
    decay of 2e-24, and -e^-8, of 0.99966) over 1,000 steps, k and v at
    WKV_EDGE_SCALE (the slow end at WKV_SLOW_SCALE), and both ends again
    at unit scale against f64 (the kernel's error at most SCAN_F64_FACTOR
    times the plain version's). At L <= 2 also the decode step's plain
    version (the sequential recurrence)."""
    from repro_torch.kernels import ref
    gen = torch.Generator(device=DEV).manual_seed(seed + 50)
    worst = {"ssm_scan": 0.0, "wkv": 0.0}
    cases = {"ssm_scan": 0, "wkv": 0}

    def held(name, rec):
        worst[name] = max(worst[name], rec["max_abs_diff"])
        cases[name] += 1

    for n in (8, 16):
        for xdt in (torch.float32, torch.bfloat16):
            for l in SCAN_EDGE_L:
                for b in SCAN_EDGE_B:
                    args = ssm_edge_inputs(gen, b, l, n, xdt,
                                           strided=(l + b) % 2 == 0)
                    for chunked in ((True, False) if l <= 2 else (True,)):
                        held("ssm_scan", bench.ssm_scan(
                            *args, chunked=chunked, quiet=True))
            args = ssm_edge_inputs(gen, 3, 129, n, xdt, underflow=True,
                                   strided=True)
            check(bool((torch.exp(args[0][..., None] * args[4]) == 0).all()),
                  "the underflow case has a decay over 0")
            held("ssm_scan", bench.ssm_scan(*args, quiet=True,
                                            label="underflow"))
    f64 = {}
    for dk in (16, 64):
        for l in SCAN_EDGE_L:
            for b in SCAN_EDGE_B:
                args = wkv_edge_inputs(gen, b, l, dk)
                for chunked in ((True, False) if l <= 2 else (True,)):
                    held("wkv", bench.wkv(*args, chunked=chunked,
                                          quiet=True))
        for logw, scale, label in (
                (-math.exp(4.0), WKV_EDGE_SCALE, "fast decay"),
                (-math.exp(-8.0), WKV_SLOW_SCALE, "slow decay")):
            held("wkv", bench.wkv(*wkv_edge_inputs(gen, 3, 1000, dk, logw,
                                                   scale), quiet=True,
                                  label=label))
            f64[f"{label.split()[0]}_dk{dk}"] = one = scan_f64(
                bench.kops.wkv, ref.wkv_chunked, ref.wkv_sequential,
                wkv_edge_inputs(gen, 3, 1000, dk, logw, 1.0))
            check(one["ok"], f"wkv at the {label}, Dk {dk}, against f64: "
                             f"{one}")
    emit({"phase": "kernel_edges_scans", "cases": cases,
          "worst_abs_err": worst, "tol": {"atol": SCAN_TOL[0],
                                          "rtol": SCAN_TOL[1]},
          "wkv_scales": {"edges": WKV_EDGE_SCALE,
                         "slow_decay": WKV_SLOW_SCALE},
          "decay_ends_unit_scale_f64": f64})
    torch.cuda.empty_cache()


def phase_kernel_scans(bench: KernelBench, families_out) -> None:
    """Both scan kernels at the families' shapes, timed, each held
    against the sequential plain version in f64 beside the plain chunked
    version (:func:`scan_f64`): the selective scan on the inputs of
    Jamba-v0.1's first Mamba layer in its FAMILY_LONG-token prefill (B 1,
    d_inner 8,192, N 16, x bf16; bf16 B and C cast, so contiguous), the
    WKV recurrence on rwkv6-7b's layer 0 of its FAMILY_LONG-token prefill
    (B 1, H 64, Dk 64). The kernels' rows compare the kernel with the
    plain version within an atol of SCAN_TOL's plus 3 times the plain
    version's largest f64 error: where the kernel sits within twice that
    error of f64 (or within SCAN_TOL of it) and the plain version within
    it, the two can be that far apart."""
    from repro_torch.kernels import ref
    for name, plain, seq in (
            ("ssm_scan", ref.ssm_scan_chunked, ref.ssm_scan_sequential),
            ("wkv", ref.wkv_chunked, ref.wkv_sequential)):
        args = families_out.pop(f"{name}_inputs")
        held = scan_f64(getattr(bench.kops, name), plain, seq, args)
        check(held["ok"], f"{name} at the families' shape against f64: "
                          f"{held}")
        tol = (SCAN_TOL[0] + 3 * max(held["plain_err"]), SCAN_TOL[1])
        getattr(bench, name)(*args, timed=True, main=True, reps=5, tol=tol,
                             extra={"f64": held})
        del args
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# whisper-medium: the encoder-decoder family
# ---------------------------------------------------------------------------

WHISPER = "whisper-medium"
WHISPER_BATCH = 8        # 30 s clips a batch, 1,500 frame embeddings each
#: the start-of-transcript sequence: <|startoftranscript|> <|en|>
#: <|transcribe|> <|notimestamps|> in whisper's multilingual vocabulary
WHISPER_PROMPT = (50258, 50259, 50359, 50363)
WHISPER_NEW = 128        # greedy tokens a clip
WHISPER_PREV = 224       # previous-text conditioning: half the text context
#: training: batch, decoder tokens (whisper's text context), steps
WHISPER_TRAIN = (4, 448, 4)
#: the f32 copy at the published widths: encoder and decoder layers;
#: batch, loss tokens and greedy tokens on the card and the CPU
WHISPER_PARITY_LAYERS = 2
WHISPER_PARITY = (2, 16, 8)
#: the device-time regions of one prefill: the encoder, and every
#: full-logits attention (the encoder's self-attention and the decoder's
#: cross-attention)
WHISPER_REGIONS = {
    "encode": ("repro_torch.models.whisper", "encode"),
    "xla_attention": ("repro_torch.models.attention", "_xla_attention"),
}


def whisper_frames(cfg, b: int, seed: int, device=None,
                   dtype=torch.bfloat16) -> torch.Tensor:
    """(B, S_enc, d) seeded frame embeddings on ``device`` (None: DEV),
    the stubbed frontend's output (from numpy, so the CPU and the card
    get the same values)."""
    x = np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_seq, cfg.d_model), dtype=np.float32)
    return torch.as_tensor(x, device=device or DEV).to(dtype)


def whisper_prompt(b: int, s: int, seed: int, device=None) -> torch.Tensor:
    """(B, S) prompts in whisper's vocabulary on ``device`` (None: DEV):
    the start-of-transcript sequence, then (S > 4) seeded previous-text
    tokens (ids below its special tokens)."""
    head = np.tile(np.asarray(WHISPER_PROMPT, np.int64), (b, 1))
    rest = np.random.default_rng(seed).integers(3, 50257,
                                                (b, s - head.shape[1]))
    return torch.as_tensor(np.concatenate([head, rest], 1),
                           device=device or DEV)


def whisper_greedy(bundle, params, frames, prompt, new: int):
    """The prefill's logits (B, 1, V) and ``new`` greedy ids (B, new):
    the first from the prefill, the rest from decode steps, the
    self-attention rings padded to the prompt plus ``new``."""
    logits, state = bundle.prefill(
        params, {"enc_embeds": frames, "tokens": prompt},
        pad_to=prompt.shape[1] + new)
    first = logits
    ids = [logits[:, 0].argmax(-1, keepdim=True)]
    for _ in range(new - 1):
        logits, state = bundle.decode(params, ids[-1], state)
        ids.append(logits[:, 0].argmax(-1, keepdim=True))
    return first, torch.cat(ids, 1)


def whisper_profile_child(seed: int) -> None:
    """In a fresh process: whisper-medium on the card, one warm-up
    prefill of WHISPER_BATCH clips and the start-of-transcript prompt,
    then one under :func:`region_shares`, and the encoder alone under it
    (its full-logits attention is the encoder's self-attention), printed
    as the last line."""
    from repro_torch.configs import get_config
    from repro_torch.models import build, whisper
    cfg = get_config(WHISPER)
    bundle = build(cfg)
    params = bundle.init(seed, device=DEV)
    inp = {"enc_embeds": whisper_frames(cfg, WHISPER_BATCH, seed + 3),
           "tokens": whisper_prompt(WHISPER_BATCH, len(WHISPER_PROMPT),
                                    seed)}
    _, warm_s = wall(lambda: bundle.prefill(params, inp))
    out = region_shares(lambda: bundle.prefill(params, inp), WHISPER_REGIONS)

    def enc():
        with torch.inference_mode():
            return whisper.encode(params, cfg, inp["enc_embeds"])

    enc_out = region_shares(enc, {"xla_attention": WHISPER_REGIONS[
        "xla_attention"]})
    att = enc_out["region_device_s"]["xla_attention"]
    print(json.dumps({
        "warm_prefill_s": warm_s, "prefill": out, "encode": enc_out,
        "complete": out["complete"] and enc_out["complete"],
        "encoder_attention_device_s": att,
        "encoder_attention_share": (att / out["device_s"]
                                    if out["device_s"] > 0 else None)}),
        flush=True)


def fresh_process(call: str) -> dict:
    """``chip_smoke.<call>`` in a process of its own (the profiler keeps
    every device event early in a process, and loses some a minute or
    more into one); waits for it and returns its last line's record."""
    code = (f"import sys; sys.path[:0] = [{os.path.join(HERE, 'src')!r}, "
            f"{HERE!r}]; import chip_smoke; chip_smoke.{call}")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=HERE)
    check(out.returncode == 0, f"{call}: exit {out.returncode}: "
                               f"{out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def phase_whisper(kops, seed: int) -> dict:
    """whisper-medium at its published widths, all 24 + 24 layers, seeded
    weights on the card. Serving: WHISPER_BATCH clips of 1,500 frames,
    the 4-token start-of-transcript prompt, WHISPER_NEW greedy tokens
    through ModelBundle.prefill / decode; a second prefill with a
    WHISPER_PREV-token prompt; flash launches by design and head dim (24
    a prefill, all wgmma at D 64); one prefill profiled in a fresh
    process. Training: WHISPER_TRAIN's steps of Trainer (AdamW, chunked,
    per-layer remat). Then the f32 copy (:func:`whisper_parity`)."""
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.models import build, whisper
    from repro_torch.train.train_loop import Trainer, TrainerConfig
    cfg = get_config(WHISPER)
    bundle = build(cfg)
    fa = kops.flash_attention
    rec = {"phase": "whisper", "arch": WHISPER, "gpu": nvidia_smi_line(),
           "layers": [cfg.encoder_layers, cfg.n_layers],
           "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
           "head_dim": cfg.hd, "encoder_seq": cfg.encoder_seq,
           "dtype": cfg.dtype, "flash": flash_key(cfg)}
    reset_peak()
    params, rec["init_s"] = wall(lambda: bundle.init(seed, device=DEV))
    rec["params"], rec["weights_bytes"] = tree_sizes(params)
    b, p0 = WHISPER_BATCH, len(WHISPER_PROMPT)
    frames = whisper_frames(cfg, b, seed + 3)
    prompt = whisper_prompt(b, p0, seed)
    prev = whisper_prompt(b, WHISPER_PREV, seed + 4)

    def encode():
        with torch.inference_mode():
            return whisper.encode(params, cfg, frames)

    encode()                                  # warm-ups, not counted
    bundle.prefill(params, {"enc_embeds": frames, "tokens": prompt})
    enc, rec["encode_s"] = wall(encode)
    check(enc.shape == (b, cfg.encoder_seq, cfg.d_model)
          and bool(torch.isfinite(enc).all()), "whisper: encoder output")
    del enc
    serve = {"batch": b, "frames": cfg.encoder_seq, "prompt": p0,
             "new_tokens": WHISPER_NEW, "prev_prompt": WHISPER_PREV}
    reset_peak()
    reset_counts(kops)
    with flash_calls(keep=1) as calls:
        (logits, state), serve["prefill_s"] = wall(lambda: bundle.prefill(
            params, {"enc_embeds": frames, "tokens": prompt},
            pad_to=p0 + WHISPER_NEW))
        first = logits
        ids = [logits[:, 0].argmax(-1, keepdim=True)]

        def decode():
            nonlocal logits, state
            for _ in range(WHISPER_NEW - 1):
                logits, state = bundle.decode(params, ids[-1], state)
                ids.append(logits[:, 0].argmax(-1, keepdim=True))
        _, serve["decode_s"] = wall(decode)
        del state
        (plog, _), serve["prefill_prev_s"] = wall(lambda: bundle.prefill(
            params, {"enc_embeds": frames, "tokens": prev}))
    serve["peak_memory_bytes"] = peak_bytes()
    serve["decode_tokens_per_s"] = b * (WHISPER_NEW - 1) / serve["decode_s"]
    counts = read_counts(kops)
    serve["flash_launches"] = counts["flash_attention"]
    serve["flash_launches_by_design"] = {k: v for k, v in
                                         fa.by_design.items() if v}
    serve["flash_calls_by_dim"] = dict(calls["by_dim"])
    ids = torch.cat(ids, 1)
    serve["greedy_ids_first_clip"] = ids[0, :16].tolist()
    check(ids.shape == (b, WHISPER_NEW) and bool((ids >= 0).all())
          and bool((ids < cfg.vocab).all()), f"whisper ids {ids.shape}")
    check(all(bool(torch.isfinite(x).all()) for x in (first, logits, plog))
          and plog.shape == (b, 1, cfg.vocab), "whisper logits")
    per = cfg.n_layers * 2            # two prefills
    check(counts["flash_attention"] == per
          and calls["by_dim"] == {"wgmma<64>": per}
          and serve["flash_launches_by_design"] == {"wgmma": per},
          f"whisper serving flash: {counts['flash_attention']} launches, "
          f"by dim {calls['by_dim']}, want {per} wgmma<64>")
    s4_qkv = calls["qkv"][0]
    check(tuple(s4_qkv[0].shape) == (b, p0, cfg.n_heads, cfg.hd)
          and tuple(calls["last_qkv"][0].shape)
          == (b, WHISPER_PREV, cfg.n_heads, cfg.hd), "whisper flash shapes")
    rec["serving"] = serve
    out = {"s4_qkv": s4_qkv, "s224_qkv": calls["last_qkv"],
           "launches": {"flash_attention_whisper": counts["flash_attention"]}}
    del calls, params, first, logits, plog, frames
    torch.cuda.empty_cache()
    rec["profile_prefill"] = fresh_process(f"whisper_profile_child({seed})")
    # -- training ---------------------------------------------------------
    bt, st, steps = WHISPER_TRAIN
    run = RunConfig()
    rng = np.random.default_rng(seed + 6)
    toks = rng.integers(3, cfg.vocab, (bt, st + 1)).astype(np.int32)
    batch = {"enc_embeds": rng.standard_normal(
        (bt, cfg.encoder_seq, cfg.d_model), dtype=np.float32),
        "tokens": toks[:, :-1], "labels": toks[:, 1:]}
    train = {"batch": bt, "seq": st, "frames": cfg.encoder_seq,
             "steps": steps, "optimizer": run.optimizer, "remat": run.remat,
             "attn_impl": run.attn_impl}
    reset_peak()
    tr, train["init_s"] = wall(lambda: Trainer(
        cfg, run, TrainerConfig(total_steps=steps), seed=seed))
    walls, kept, t_prev = [], [], [0.0]

    def hook(step, m):
        sync()
        now = time.perf_counter()
        walls.append(now - t_prev[0])
        t_prev[0] = now

    reset_counts(kops)
    with first_backward_inputs(kept):
        sync()
        t_prev[0] = time.perf_counter()
        tr.run_loop(iter([batch] * steps), hook=hook)
    counts = read_counts(kops)
    train["peak_memory_bytes"] = peak_bytes()
    losses = [m["loss"] for m in tr.history]
    train.update(losses=losses, step_walls_s=walls,
                 step_wall_median_s=float(np.median(walls)),
                 tokens_per_s=bt * st / float(np.median(walls)),
                 frames_per_s=bt * cfg.encoder_seq / float(np.median(walls)),
                 launches={k: counts[k] for k in PATH_KERNELS["whisper"]},
                 flash_launches_by_design=dict(fa.by_design),
                 bwd_launches_by_design={
                     k: dict(getattr(kops, k).by_design)
                     for k in ("flash_bwd_dkdv", "flash_bwd_dq")})
    check(len(losses) == steps and all(map(math.isfinite, losses))
          and losses[-1] < losses[0], f"whisper train losses {losses}")
    per = cfg.n_layers * steps
    check(fa.launches == 2 * per and fa.by_design["wgmma"] == 2 * per,
          f"whisper train flash forward {fa.by_design}, want {2 * per} "
          f"wgmma (a forward and a remat recompute per decoder layer)")
    for k in ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq"):
        check(counts[k] == per, f"whisper {k}: {counts[k]}, want {per}")
    for k, by in train["bwd_launches_by_design"].items():
        check(by["wgmma"] == per, f"whisper {k} by design {by}")
    rec["training"] = train
    out["bwd_inputs"] = kept[0]
    out["launches"]["flash_attention_whisper"] += counts["flash_attention"]
    out["launches"].update({f"{k}_whisper": counts[k] for k in (
        "flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq")})
    del tr
    torch.cuda.empty_cache()
    parity = whisper_parity(kops, seed)
    rec["parity_f32"] = {k: v for k, v in parity.items() if k != "launches"}
    out["launches"]["flash_attention_whisper_f32"] = parity["launches"].get(
        "flash_attention", 0)
    emit(rec)
    return out


def whisper_parity(kops, seed: int) -> dict:
    """whisper-medium's widths at WHISPER_PARITY_LAYERS + its layers in
    f32 from one host tree, on the CPU and the card, ``chunked`` (the
    card's flash kernels, wgmma_f32 at D 64; the CPU's plain versions):
    greedy ids equal, prefill logits within SMOKE_TOL, the loss and every
    gradient leaf within BWD_TOL[f32] (relative to the leaf's largest
    magnitude). The card run's launches are counted from 0."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import FwdOpts, build, weights
    cfg = dataclasses.replace(get_config(WHISPER), dtype="float32",
                              n_layers=WHISPER_PARITY_LAYERS,
                              encoder_layers=WHISPER_PARITY_LAYERS)
    tree = weights.random_tree(cfg, np.random.default_rng(seed + 7))
    bundle = build(cfg)
    b, s, new = WHISPER_PARITY
    rng = np.random.default_rng(seed + 8)
    toks = rng.integers(3, cfg.vocab, (b, s + 1))
    res = {}
    for dev in ("cpu", DEV):
        params = weights.from_jax_tree(cfg, tree, device=dev)
        frames = whisper_frames(cfg, b, seed + 9, dev, torch.float32)
        prompt = whisper_prompt(b, len(WHISPER_PROMPT), seed, dev)
        batch = {"enc_embeds": frames,
                 "tokens": torch.as_tensor(toks[:, :-1], device=dev),
                 "labels": torch.as_tensor(toks[:, 1:], device=dev)}
        if dev == DEV:
            reset_counts(kops)
        first, ids = whisper_greedy(bundle, params, frames, prompt, new)
        (loss, _), grads = value_and_grad(
            lambda p: bundle.loss(p, batch, FwdOpts(attn_impl="chunked")),
            params)
        res[dev] = (first.cpu(), ids.cpu(), float(loss),
                    weights.to_jax_tree(cfg, grads))
        if dev == DEV:
            launches = {k: v for k, v in read_counts(kops).items() if v}
            by_design = {k: v for k, v in
                         kops.flash_attention.by_design.items() if v}
        del params, grads
    (lc, ic, losc, gc), (lg, ig, losg, gg) = res["cpu"], res[DEV]
    atol, rtol = BWD_TOL[torch.float32]
    worst = 0.0
    for (pc, a), (_, g) in zip(_jax_leaves(gc), _jax_leaves(gg)):
        scale = float(np.abs(a).max())
        e = float(np.abs(a - g).max()) / max(atol + rtol * scale, 1e-30)
        worst = max(worst, e)
    out = {"layers": [cfg.encoder_layers, cfg.n_layers], "batch": b,
           "loss_tokens": s, "greedy_tokens": new,
           "ids_equal": bool(torch.equal(ic, ig)),
           "max_abs_logit_diff": float((lc - lg).abs().max()),
           "logit_tol": SMOKE_TOL, "loss_cpu": losc, "loss_card": losg,
           "loss_diff": abs(losc - losg), "grad_err_in_tol": worst,
           "bwd_tol": {"atol": atol, "rtol": rtol}, "launches": launches,
           "flash_launches_by_design": by_design}
    check(out["ids_equal"], "whisper f32: greedy ids differ, cpu vs card")
    check(out["max_abs_logit_diff"] <= SMOKE_TOL,
          f"whisper f32: logits differ by {out['max_abs_logit_diff']}")
    check(out["loss_diff"] <= atol + rtol * abs(losc),
          f"whisper f32: loss {losg} vs {losc}")
    check(worst <= 1.0, f"whisper f32: a gradient {worst} x its tolerance")
    n = WHISPER_PARITY_LAYERS
    want = {"wgmma_f32": n + 2 * n}  # the prefill; the loss and its remat
    check(by_design == want and launches.get("flash_bwd_dkdv") == n
          and launches.get("flash_bwd_dq") == n,
          f"whisper f32 launches {launches}, by design {by_design}")
    return out


def _jax_leaves(tree, path=""):
    """(path, array) of a JAX-layout host tree's leaves, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _jax_leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _jax_leaves(v, f"{path}/{i}")
    else:
        yield path, np.asarray(tree, np.float64)


#: whisper's decoder attention, multi-head (a group of 1) at D 64: the
#: prompt lengths of its paths, B 2
WHISPER_EDGE_S = (4, WHISPER_PREV, WHISPER_TRAIN[1])


def phase_kernel_edges_whisper(bench: KernelBench, seed: int) -> None:
    """Flash forward and backward at whisper's heads (H 16 / K 16, D 64)
    and prompt lengths (WHISPER_EDGE_S: ragged against the kernels'
    64- and 128-row tiles) in bf16 and f32 on seeded inputs: the forward
    against its plain version within FLASH_TOL on its design (wgmma,
    wgmma_f32), delta, dK, dV and dQ against the plain backward within
    BWD_TOL on the backward's design; the worst error per check."""
    from repro_torch.kernels import flash_attention as fa
    kops, ref = bench.kops, bench.kops.ref
    gen = torch.Generator(device=DEV).manual_seed(seed + 12)
    worst, designs = {}, {}
    for dt in (torch.bfloat16, torch.float32):
        for s in WHISPER_EDGE_S:
            q, k, v, do = bwd_inputs(gen, 2, s, s, 16, 16, 64, "contiguous",
                                     dt)
            f = bench.flash(q, k, v, timed=False, quiet=True,
                            name="flash_attention_whisper")
            o, lse = fa._forward(q, k, v, lse=True)
            delta = kops.flash_bwd_delta(o, do)
            dk, dv = kops.flash_bwd_dkdv(q, k, v, do, lse, delta)
            dq = kops.flash_bwd_dq(q, k, v, do, lse, delta)
            want = ref.ref_flash_attention_bwd(q, k, v, o, lse, do,
                                               bq=PLAIN_FLASH_TILE,
                                               bk=PLAIN_FLASH_TILE)
            tag = str(dt).split(".")[-1]
            designs[tag] = [f["shape"]["design"],
                            fa.bwd_plan(q, k, v, do).design]
            worst[f"forward_{tag}"] = max(worst.get(f"forward_{tag}", 0.0),
                                          f["max_abs_diff"])
            for name, g_, w_, tol in (
                    ("delta", delta, ref.ref_flash_bwd_delta(o, do),
                     BWD_TOL[torch.float32]),
                    ("dq", dq, want[0], BWD_TOL[dt]),
                    ("dk", dk, want[1], BWD_TOL[dt]),
                    ("dv", dv, want[2], BWD_TOL[dt])):
                ok, err = within(g_, w_, tol)
                check(ok, f"whisper flash backward {name} S {s} {dt}: {err}")
                key = f"{name}_{tag}"
                worst[key] = max(worst.get(key, 0.0), err)
    check(designs == {"bfloat16": ["wgmma", "wgmma"],
                      "float32": ["wgmma_f32", "wgmma_f32"]},
          f"whisper flash designs {designs}")
    emit({"phase": "kernel_edges_whisper", "heads": [16, 16], "D": 64,
          "S": list(WHISPER_EDGE_S), "designs": designs,
          "worst_abs_err": worst,
          "tol": {"flash": {str(k).split(".")[-1]: v
                            for k, v in FLASH_TOL.items()},
                  "bwd": {str(k).split(".")[-1]: v
                          for k, v in BWD_TOL.items()}}})


def phase_kernel_whisper(bench: KernelBench, whisper_out, seed: int) -> None:
    """Flash attention at whisper's decoder shapes against its plain
    version and SDPA: bf16 on layer 23's q, k, v of the WHISPER_PREV-token
    prefill (B 8, H 16 / K 16, D 64; wgmma) and the same values in f32
    (wgmma_f32); the 4-token prompt's layer-0 q, k, v checked; the
    backward's three kernels on the first backward of whisper's training
    (the last decoder layer, B 4 x S 448) in bf16, its q, k, v, o and lse
    with a seeded unit-scale dO, held ``scaled`` (the step's own dO gives
    gradients under BWD_TOL's atol)."""
    q, k, v = whisper_out.pop("s4_qkv")
    bench.flash(q, k, v, timed=False, name="flash_attention_whisper")
    q, k, v = whisper_out.pop("s224_qkv")
    bench.flash(q, k, v, main=True, name="flash_attention_whisper",
                rounds=3, device=True)
    bench.flash(*(x.float() for x in (q, k, v)), main=True,
                name="flash_attention_whisper_f32", rounds=3, device=True)
    q, k, v, o, lse, _ = (x.detach() for x in whisper_out.pop("bwd_inputs"))
    gen = torch.Generator(device=DEV).manual_seed(seed + 37)
    do = torch.randn(q.shape, generator=gen, device=DEV).to(q.dtype)
    bench.flash_bwd(q, k, v, o, lse, do, suffix="_whisper", scaled=True)
    del q, k, v, o, lse, do
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# tiles: the kernels' tile resolution and its autotune sweep
# ---------------------------------------------------------------------------

TILE_ROUTE_KEYS = 606_894   # the sharding phase's last release, 4 shards
TILE_MASK_CELLS = 4_706_255  # the main path's compacted log


@contextlib.contextmanager
def tile_env(launch, kernel: str, tile: int):
    """``GESTORE_TILE_<KERNEL>`` set to ``tile`` inside the block."""
    var = launch.ENV_PREFIX + kernel.upper()
    old = os.environ.get(var)
    os.environ[var] = str(tile)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(var, None)
        else:
            os.environ[var] = old


def phase_tiles(bench: KernelBench, kops, seed: int) -> dict:
    """``launch.sweep`` on the card for the route (flat key bytes,
    TILE_ROUTE_KEYS keys, N_SHARDS shards) and the keep mask
    (TILE_MASK_CELLS cells) over the candidates each can launch: every
    candidate's output bit for bit against the plain version at that
    tile, its times and bound (a kernel line each), the winner by the
    card's time per call (device_ms) recorded in the winner cache
    (``GESTORE_TORCH_TILE_CACHE``, under the run's temporary root); a
    second sweep answers from the cache and ``tile_for`` returns the
    winner. The codec is not swept: its tile is every segment's stat
    tile, and stays the default."""
    from repro_torch.kernels import launch
    rec = {"phase": "tiles", "gpu": nvidia_smi_line(),
           "device": launch.platform(DEV), "cache": os.path.relpath(
               launch.cache_path(), HERE)}
    keys = keys_of(np.arange(TILE_ROUTE_KEYS))
    flat, offsets = (torch.as_tensor(x, device=DEV)
                     for x in kops.key_bytes(keys))
    rng = np.random.default_rng(seed + 11)
    ts = torch.as_tensor(rng.choice(RELEASE_TS, TILE_MASK_CELLS).astype(
        np.int32), device=DEV)
    runs = {"shard_route": (TILE_ROUTE_KEYS, lambda: bench.shard_route_bytes(
                flat, offsets, N_SHARDS, quiet=False)),
            "compact_rewrite": (TILE_MASK_CELLS, lambda: bench.keep_mask(
                ts, COMPACT_TS))}
    reset_counts(kops)
    for kernel, (n, one) in runs.items():
        rows = {}

        def time_at(tile, kernel=kernel, one=one, rows=rows):
            with tile_env(launch, kernel, tile):
                r = one()
            check(r["shape"]["tile"] == tile, f"{kernel}: ran tile "
                                               f"{r['shape']['tile']}")
            rows[tile] = {k: r[k] for k in ("kernel_ms", "device_ms",
                                            "plain_ms", "bound_ms",
                                            "max_abs_diff")}
            return r["device_ms"] / 1e3

        first, wall_s = wall(lambda: launch.sweep(kernel, time_at, n=n,
                                                  device=DEV))
        again = launch.sweep(kernel, time_at, n=n, device=DEV)
        want = [t for t in launch.SWEEP_CANDIDATES[kernel]
                if launch.launchable(kernel, t)]
        check(not first["cached"] and sorted(first["walls"]) == want,
              f"{kernel}: swept {sorted(first['walls'])}, want {want}")
        check(again["cached"] and again["tile"] == first["tile"]
              and launch.tile_for(kernel, n=n, device=DEV) == first["tile"],
              f"{kernel}: second sweep {again}, tile_for "
              f"{launch.tile_for(kernel, n=n, device=DEV)}")
        rec[kernel] = {"n": n, "bucket": first["bucket"],
                       "winner": first["tile"],
                       "default": launch.DEFAULT_TILES[kernel],
                       "sweep_wall_s": wall_s, "second_sweep": again,
                       "by_tile": rows}
    rec["delta_codec_tile"] = launch.tile_for("delta_codec", n=TILE_MASK_CELLS,
                                              device=DEV)
    check(rec["delta_codec_tile"] == launch.DEFAULT_TILES["delta_codec"],
          f"the codec's tile moved: {rec['delta_codec_tile']}")
    counts = read_counts(kops)
    rec["launches"] = {k: counts[k] for k in PATH_KERNELS["tiles"]}
    for k in PATH_KERNELS["tiles"]:
        check(counts[k] > 0, f"tiles: {k} was not launched")
    emit(rec)
    return rec


# ---------------------------------------------------------------------------
# versioned search: the Meta-pipe application (table4_application)
# ---------------------------------------------------------------------------

SEARCH_ROWS = 570_000  # UniProtKB/Swiss-Prot's entries
SEARCH_SEQ_W = 32      # table4_application's SEQ_W, alphabet 0-24
SEARCH_CHURN = 0.031   # table4_application's CHURN
SEARCH_BATCH = 4096    # sequences per encoder call, the last one padded
SEARCH_QUERIES, SEARCH_K, SEARCH_SEG, SEARCH_TAU = 8, 10, 64, 4.0
CORPUS_DOCS = 20_000
CORPUS_CHURN = 0.031


def metapipe_encoder(params, cfg, impl: str):
    """table4_application's encoder on the card: tokens mod the vocab
    through ``forward_train`` (under inference mode), the hidden states
    mean-pooled over the sequence, in batches of SEARCH_BATCH rows with
    the last padded by zero rows. Every call has one shape, so a row's
    embedding does not depend on the rows batched with it, and the
    incremental refresh embeds a changed row to the same bits as the full
    one."""
    from repro_torch.models.transformer import FwdOpts, forward_train
    opts = FwdOpts(attn_impl=impl)

    @torch.inference_mode()
    def enc(tokens: np.ndarray) -> np.ndarray:
        out = []
        for i in range(0, len(tokens), SEARCH_BATCH):
            chunk = tokens[i:i + SEARCH_BATCH]
            pad = SEARCH_BATCH - len(chunk)
            if pad:
                chunk = np.concatenate([chunk, np.zeros(
                    (pad, chunk.shape[1]), chunk.dtype)])
            t = torch.as_tensor(chunk, device=DEV) % cfg.vocab
            x, _ = forward_train(params, cfg, {"tokens": t}, opts)
            out.append(x.mean(dim=1).float().cpu().numpy()[:len(chunk) - pad])
        return (np.concatenate(out) if out
                else np.zeros((0, cfg.d_model), np.float32))
    return enc


def encoder_check(kops, params, cfg, tokens: np.ndarray) -> dict:
    """The encoder's hidden states on one batch through ``chunked`` (the
    flash kernel) and ``xla`` (torch ops), both in bf16, and through
    ``xla`` and ``chunked`` in f32 with the same weights. The two bf16
    paths differ only in how attention rounds to bf16 (flash: once from
    its f32 online softmax; xla: f32 logits and probabilities, rounded at
    the output), and four layers carry each rounding through the residual
    stream and the MLP. The tolerance is the model's own bf16 rounding:
    chunked must be as close to xla as xla is to the f32 model (max and
    RMS), and no further from the f32 model than xla is (within 5%). In
    f32 chunked (the ``mma_f32`` flash kernel) must be within
    ENCODER_F32_TOL * max(1, max |xla|) of xla. Returns the record (the
    f32 run's flash launches by design under ``f32_flash_launches``) and
    the layer-0 q, k, v the flash kernel was handed in bf16 and in f32."""
    from repro_torch.models.transformer import FwdOpts, forward_train
    t = torch.as_tensor(tokens, device=DEV) % cfg.vocab
    p32 = weights_like(params, torch.float32)
    c32 = dataclasses.replace(cfg, dtype="float32")

    def run():
        with torch.inference_mode(), layer0_inputs(cfg.n_layers) as kept:
            xc = forward_train(params, cfg, {"tokens": t},
                               FwdOpts("chunked"))[0].float()
            xx = forward_train(params, cfg, {"tokens": t},
                               FwdOpts("xla"))[0].float()
            xf = forward_train(p32, c32, {"tokens": t}, FwdOpts("xla"))[0]
        return xc, xx, xf, kept[0]

    def run_f32():
        with torch.inference_mode(), layer0_inputs(cfg.n_layers) as kept:
            xcf = forward_train(p32, c32, {"tokens": t},
                                FwdOpts("chunked"))[0]
        return xcf, kept[0]
    xc, xx, xf, qkv = uncounted(kops, run)
    f32_flash = {}
    xcf, qkv32 = uncounted(kops, run_f32, f32_flash)

    def err(a, b):
        d = a - b
        return float(d.abs().max()), float(d.pow(2).mean().sqrt())
    rec = {"rows": len(tokens), "max_abs_hidden": float(xx.abs().max()),
           "chunked_vs_xla": err(xc, xx), "xla_vs_f32": err(xx, xf),
           "chunked_vs_f32": err(xc, xf),
           "f32_chunked_vs_xla": err(xcf, xf),
           "f32_tol": ENCODER_F32_TOL * max(1.0, float(xf.abs().max())),
           "f32_flash_launches": f32_flash}
    (cx_max, cx_rms), (xf_max, xf_rms) = (rec["chunked_vs_xla"],
                                          rec["xla_vs_f32"])
    rec["ok"] = (cx_max <= xf_max and cx_rms <= xf_rms
                 and rec["chunked_vs_f32"][0] <= 1.05 * xf_max)
    rec["f32_ok"] = rec["f32_chunked_vs_xla"][0] <= rec["f32_tol"]
    return rec, qkv, qkv32


def weights_like(tree, dtype):
    """The parameter tree with every tensor cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: weights_like(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [weights_like(v, dtype) for v in tree]
    return tree.to(dtype)


def search_same(a, b) -> bool:
    """Two search results bit for bit: global and per-segment top-k,
    scores, log-sum-exps, and z."""
    return all(np.array_equal(x, y) for x, y in (
        (a.topk_idx, b.topk_idx), (a.topk_score, b.topk_score),
        (a.z, b.z), (a.seg_topk_idx, b.seg_topk_idx),
        (a.seg_topk_score, b.seg_topk_score), (a.seg_lse, b.seg_lse)))


def phase_search(core, kops, seed: int) -> dict:
    """table4_application at Swiss-Prot scale on the card: a corpus of
    570,000 sequences (32 x int32) and a second release at 3.1% churn,
    the Meta-pipe encoder at its published widths (bf16, seeded random
    weights, flash attention), EmbeddingSearchDB with a full refresh and
    query, the incremental query to version 2 and a full recompute there;
    then a VersionedCorpus of 20,000 documents released twice."""
    from repro_torch.configs.metapipe import ENCODER
    from repro_torch.models import build
    rng = np.random.default_rng(seed + 21)
    rec = {"phase": "search", "rows": SEARCH_ROWS, "seq_w": SEARCH_SEQ_W,
           "churn": SEARCH_CHURN, "encoder": dataclasses.asdict(ENCODER),
           "batch": SEARCH_BATCH, "queries": SEARCH_QUERIES, "k": SEARCH_K,
           "seg_size": SEARCH_SEG, "tau": SEARCH_TAU}
    reset_counts(kops)
    store = core.VersionedStore(
        "metapipe", [core.FieldSchema("sequence", SEARCH_SEQ_W, "int32")],
        capacity=SEARCH_ROWS + 64)
    keys = [b"d%d" % i for i in range(SEARCH_ROWS)]
    seqs = rng.integers(0, 25, (SEARCH_ROWS, SEARCH_SEQ_W), dtype=np.int32)
    _, rec["release_1_s"] = wall(lambda: store.update(
        1, keys, {"sequence": seqs}))
    seqs2 = seqs.copy()
    n_mut = int(SEARCH_CHURN * SEARCH_ROWS)
    seqs2[rng.choice(SEARCH_ROWS, n_mut, replace=False)] = rng.integers(
        0, 25, (n_mut, SEARCH_SEQ_W))
    _, rec["release_2_s"] = wall(lambda: store.update(
        2, keys, {"sequence": seqs2}))
    n_changed = int((seqs != seqs2).any(axis=1).sum())
    t0 = time.perf_counter()
    params = build(ENCODER).init(seed, DEV)
    rec["encoder_check"], qkv, qkv32 = encoder_check(kops, params, ENCODER,
                                                     seqs[:SEARCH_BATCH])
    rec["encoder_check_s"] = time.perf_counter() - t0
    enc_rec = rec["encoder_check"]
    check(enc_rec["ok"],
          f"encoder: chunked differs from xla beyond bf16's own rounding: "
          f"{enc_rec}")
    check(enc_rec["f32_ok"],
          f"encoder: f32 chunked differs from f32 xla by "
          f"{enc_rec['f32_chunked_vs_xla']}, over {enc_rec['f32_tol']}")
    f32_launches = enc_rec["f32_flash_launches"]
    check(f32_launches["mma_f32"] == ENCODER.n_layers
          and sum(f32_launches.values()) == ENCODER.n_layers,
          f"encoder: the f32 run's flash launches {f32_launches}, not "
          f"{ENCODER.n_layers} of mma_f32")
    enc = metapipe_encoder(params, ENCODER, "chunked")
    q = rng.integers(0, 25, (SEARCH_QUERIES, SEARCH_SEQ_W), dtype=np.int32)
    qids = [b"q%d" % i for i in range(SEARCH_QUERIES)]

    db = core.EmbeddingSearchDB(store, enc, seg_size=SEARCH_SEG,
                                tau=SEARCH_TAU)
    rec["full_embedded"], rec["full_embed_s"] = wall(lambda: db.refresh(1))
    r1, rec["full_query_s"] = wall(lambda: db.query(qids, q, ts=1,
                                                    k=SEARCH_K))
    prof = device_profile(lambda: db.query(qids, q, ts=1, k=SEARCH_K),
                          plain_wall_s=rec["full_query_s"])
    rec["full_query_profile"] = prof
    acc = {}
    with timed_calls(db, "refresh", acc), timed_calls(db, "query", acc):
        r2, rec["incremental_s"] = wall(lambda: db.incremental_query(
            r1, qids, q, t_last=1, ts=2, k=SEARCH_K))
    rec["incremental_refresh_s"] = acc["refresh"]
    rec["incremental_query_s"] = acc["query"]
    rec["incremental_embedded"] = r2.n_embedded
    rec["changed_segments"] = int(len(db.changed_segments(1, 2)))
    rec["segments"] = db.n_segments()
    full = core.EmbeddingSearchDB(store, enc, seg_size=SEARCH_SEG,
                                  tau=SEARCH_TAU)
    _, rec["recompute_embed_s"] = wall(lambda: full.refresh(2))
    rf, rec["recompute_query_s"] = wall(lambda: full.query(
        qids, q, ts=2, k=SEARCH_K))
    check(search_same(r2, rf), "search: the incremental result differs "
          "from the full recompute")
    check(rec["full_embedded"] == SEARCH_ROWS, "full embed rows")
    check(r2.n_embedded == n_changed, f"search: embedded {r2.n_embedded} "
          f"rows, {n_changed} changed")
    check(np.isfinite(r1.z).all() and np.isfinite(rf.z).all()
          and (r1.topk_idx >= 0).all(), "search: a non-finite z or empty "
          "top-k")
    rec["n_changed"] = n_changed
    rec["topk_changed_queries"] = int((r1.topk_idx != rf.topk_idx)
                                      .any(axis=1).sum())
    rec["corpus"], rec["corpus_s"] = wall(lambda: corpus_check(rng))
    rec["launches"] = read_counts(kops)
    rec["flash_launches_by_design"] = dict(kops.flash_attention.by_design)
    emit(rec)
    for k in PATH_KERNELS["search"]:
        check(rec["launches"][k] > 0,
              f"kernel {k} never launched on the search path")
    check(rec["flash_launches_by_design"]["mma"]
          == rec["launches"]["flash_attention"],
          "search: a flash launch took another design than mma")
    del db, full, store
    # the kernels line's D 16 rows time shapes no path launches; the f32
    # D 32 row's launches are the encoder check's f32 run
    return {"launches": {**rec["launches"], "flash_attention_d32":
                         rec["flash_launches_by_design"]["mma"],
                         "flash_attention_d16": 0,
                         "flash_attention_d32_f32": f32_launches["mma_f32"],
                         "flash_attention_d16_f32": 0},
            "qkv": qkv, "qkv32": qkv32}


def corpus_check(rng) -> dict:
    """A VersionedCorpus on the card: two releases of CORPUS_DOCS
    documents, the second with CORPUS_CHURN of them edited, 1% deleted and
    1% new, through ``incremental_release``; only the changed and new
    documents are tokenized, and each version's token stream equals that
    of a corpus given both releases whole."""
    from repro_torch.data.versioned_dataset import VersionedCorpus
    words = np.array(["sequence", "protein", "kinase", "domain", "binding",
                      "membrane", "transport", "GeStore", "release", "meta"])

    def doc(n):
        return " ".join(words[rng.integers(0, len(words), n)])
    docs = {f"doc{i:06d}": doc(int(rng.integers(5, 100)))
            for i in range(CORPUS_DOCS)}
    names = list(docs)
    docs2 = dict(docs)
    for i in rng.choice(CORPUS_DOCS, int(CORPUS_CHURN * CORPUS_DOCS),
                        replace=False):
        docs2[names[i]] = doc(int(rng.integers(5, 100)))
    for i in rng.choice(CORPUS_DOCS, CORPUS_DOCS // 100, replace=False):
        docs2.pop(names[i], None)
    for i in range(CORPUS_DOCS // 100):
        docs2[f"new{i:06d}"] = doc(int(rng.integers(5, 100)))
    changed = sum(k not in docs or docs[k] != v for k, v in docs2.items())
    inc, full = VersionedCorpus("inc"), VersionedCorpus("full")
    check(inc.store.device.type == torch.device(DEV).type,
          f"VersionedCorpus without device= is on {inc.store.device}")
    rec = {"docs": [len(docs), len(docs2)], "changed_or_new": changed}
    _, rec["add_release_s"] = wall(lambda: inc.add_release(10, docs))
    n0 = inc.tokens_encoded_total
    _, rec["incremental_release_s"] = wall(lambda: inc.incremental_release(
        10, 20, docs2))
    rec["tokenized"] = inc.tokens_encoded_total - n0
    check(rec["tokenized"] == changed, f"corpus: tokenized {rec['tokenized']}"
          f" documents, {changed} changed or new")
    full.add_release(10, docs)
    full.add_release(20, docs2)
    for t in (10, 20):
        check(same_bytes(inc.token_stream(t), full.token_stream(t)),
              f"corpus: token stream of version {t} differs")
    rec["tokens_v20"] = int(len(inc.token_stream(20)))
    return rec


def phase_kernel_search(bench: KernelBench, search_out, seed: int) -> None:
    """Flash attention at the encoder's shape, each timed in alternating
    rounds with SDPA and with its device time alone: layer 0's q, k, v of
    one batch of the search path (B 4096 x S 32, 8 heads, D 32, bf16: the
    mma design); the same shape at D 16 in bf16 (the mma design, from
    the seed); layer 0's q, k, v of the encoder check's f32 run (the
    mma_f32 design); the same shape at D 16 in f32 (mma_f32, from the
    seed). Each row also with a null lse pointer (serving, search) and
    with the lse written (training) in alternating rounds (lse_rounds),
    and the backward's three kernels on its q, k, v, the forward's o and
    lse and a seeded dO (flash_bwd_*_d32, _d16, _d32_f32, _d16_f32: the
    mma designs' backward)."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=DEV).manual_seed(seed + 22)
    q, k, v = search_out.pop("qkv")
    q32, k32, v32 = search_out.pop("qkv32")
    rows = {"d32": (q, k, v),
            "d16": tuple(torch.randn(*x.shape[:3], 16, generator=gen,
                                     device=DEV).to(x.dtype)
                         for x in (q, k, v)),
            "d32_f32": (q32, k32, v32),
            "d16_f32": tuple(torch.randn(*x.shape[:3], 16, generator=gen,
                                         device=DEV) for x in (q32, k32, v32))}
    for sfx, (qq, kk, vv) in rows.items():
        name = f"flash_attention_{sfx}"
        bench.flash(qq, kk, vv, main=True, name=name, rounds=TIMED_ROUNDS,
                    device=True)
        bench.main[name].update(lse_rounds(bench, qq, kk, vv))
        do = torch.randn(qq.shape, generator=gen, device=DEV).to(qq.dtype)
        o, lse = fa._forward(qq, kk, vv, lse=True)
        bench.flash_bwd(qq, kk, vv, o, lse, do, suffix=f"_{sfx}",
                        scaled=True)
        del do, o, lse
    del rows, q, k, v, q32, k32, v32
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# training: the flash backward's edges, llama3.2-1b's train path, chunked
# against xla, delta checkpoints
# ---------------------------------------------------------------------------

def bwd_edge_shapes() -> list:
    """(B, Sq, Sk, H, K, D, layout) of the backward's edge cases: every
    head dim, D 8/16/32 (the mma designs) and 64/112/128 (the wgmma ones,
    D 112 in D 128's tiles), GQA groups 1 and 4, S 1/127/128/129/1,000
    (one tile, a tile - 1, a tile, a tile + 1 over 64-row tiles, many
    tiles; ragged over the mma designs' 16-row strips and 32-row tiles
    too), Sq < Sk (keys ahead of every query), Sq > Sk (rows that see no
    key), q as a transposed view (read as it lies) or with padded rows
    (strides no multiple of 4 elements: copied), a contiguous k one
    element past an aligned base (copied), at D 8/16/32 seven heads over
    one KV head (qwen2-0.5b-smoke's grouping, several heads a block), and
    at D 112 kimi-k2's 64 heads over 8 (G 8) at S 129 and 1,000."""
    out = []
    for d in (8, 16, 32, 64, 112, 128):
        if d < 64:
            out.append((2, 65, 65, 7, 1, d, "contiguous"))
        if d == 112:
            out += [(2, 129, 129, 64, 8, d, "contiguous"),
                    (1, 1000, 1000, 64, 8, d, "contiguous")]
        for g in (1, 4):
            for s in (1, 127, 128, 129, 1000):
                out.append((1 if s == 1000 else 2, s, s, 2 * g, 2, d,
                            "contiguous"))
        out += [(1, 100, 300, 4, 1, d, "contiguous"),
                (2, 129, 1000, 8, 2, d, "contiguous"),
                (1, 200, 70, 4, 2, d, "contiguous"),
                (2, 127, 127, 8, 2, d, "transposed_q"),
                (1, 129, 129, 4, 4, d, "padded_q"),
                (1, 100, 130, 4, 2, d, "misaligned_k")]
    return out


def bwd_inputs(gen, b, sq, sk, h, kh, d, layout, dt):
    q, k, v, do = (torch.randn(*shape, generator=gen, device=DEV).to(dt)
                   for shape in ((b, sq, h, d), (b, sk, kh, d),
                                 (b, sk, kh, d), (b, sq, h, d)))
    if layout == "transposed_q":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif layout == "padded_q":
        q = torch.cat([q, q[..., :2]], -1)[..., :d]
    elif layout == "misaligned_k":
        k = torch.empty(k.numel() + 1, dtype=dt, device=DEV)[1:].view(
            k.shape).copy_(k)
    return q, k, v, do


def within(got, want, tol) -> tuple[bool, float]:
    d = (got.float() - want.float()).abs()
    if not d.numel():
        return True, 0.0
    return (bool((d <= tol[0] + tol[1] * want.float().abs()).all()),
            float(d.max()))


def phase_kernel_edges_train(bench: KernelBench, rng) -> None:
    """The backward's three kernels at the edge shapes, f32 and bf16,
    each against the plain backward on the same forward o and lse within
    BWD_TOL: every case through the kernels of its (dtype, D)'s design
    (bf16 wgmma and f32 wgmma_f32 at D 64/112/128, bf16 mma and f32
    mma_f32 at D 8/16/32; each call's launch counted on its design), the
    worst error per gradient and design; the forward's lse, every design's,
    against the plain version's (LSE_TOL; -1e30 exactly for rows that see
    no key); the plain backward
    against f64 autograd through ``ref_attention`` (f32 cases where every
    row sees a key, within BWD_TOL[f32]); and the autograd path
    (``flash_attention`` with inputs that need grad, and a scalar loss's
    zero-stride dO) handing q, k and v the kernels' gradients bit for
    bit, at every head dim."""
    from repro_torch.kernels import flash_attention as fa
    kops, ref = bench.kops, bench.kops.ref
    gen = torch.Generator(device=DEV).manual_seed(int(rng.integers(1 << 31)))
    worst: dict = {}
    n_cases, n_f64, copies = 0, 0, 0
    cases_by_design = dict.fromkeys(fa.BWD_DESIGNS, 0)
    want_by_design = dict.fromkeys(fa.BWD_DESIGNS, 0)
    lse_worst: dict = {}
    for shape in bwd_edge_shapes():
        for dt in (torch.float32, torch.bfloat16):
            b, sq, sk, h, kh, d, layout = shape
            q, k, v, do = bwd_inputs(gen, *shape, dt)
            copies += bool(fa.bwd_plan(q, k, v, do).copies)
            o, lse = fa._forward(q, k, v, lse=True)
            _, lse_want = ref.ref_flash_attention(
                q, k, v, bq=PLAIN_FLASH_TILE, bk=PLAIN_FLASH_TILE,
                return_lse=True)
            seen = lse_want > -1e29
            ok, err = within(lse[seen], lse_want[seen], LSE_TOL)
            check(ok and bool((lse[~seen] == -1e30).all()),
                  f"lse {shape} {dt}: {err}")
            delta = kops.flash_bwd_delta(o, do)
            # the forward's design of (dtype, D)
            design = fa.bwd_plan(q, k, v, do).design
            lse_worst[design] = max(lse_worst.get(design, 0.0), err)
            want_by_design[fa.design(dt, d)] += 1
            check(design == fa.design(dt, d),
                  f"{shape} {dt}: backward design {design}")
            before = [dict(w.by_design)
                      for w in (kops.flash_bwd_dkdv, kops.flash_bwd_dq)]
            dk, dv = kops.flash_bwd_dkdv(q, k, v, do, lse, delta)
            dq = kops.flash_bwd_dq(q, k, v, do, lse, delta)
            for w, b0 in zip((kops.flash_bwd_dkdv, kops.flash_bwd_dq),
                             before):
                check({k_: n - b0[k_] for k_, n in w.by_design.items()}
                      == {k_: int(k_ == design) for k_ in b0},
                      f"{shape} {dt}: launches by design {w.by_design}")
            cases_by_design[design] += 1
            sync()
            want = ref.ref_flash_attention_bwd(q, k, v, o, lse, do,
                                               bq=PLAIN_FLASH_TILE,
                                               bk=PLAIN_FLASH_TILE)
            got = {"delta": (delta, ref.ref_flash_bwd_delta(o, do),
                             BWD_TOL[torch.float32]),
                   "dq": (dq, want[0], BWD_TOL[dt]),
                   "dk": (dk, want[1], BWD_TOL[dt]),
                   "dv": (dv, want[2], BWD_TOL[dt])}
            for name, (g_, w_, tol) in got.items():
                check(g_.dtype == w_.dtype and g_.shape == w_.shape,
                      f"{name} {shape}: {g_.dtype} {g_.shape}")
                ok, err = within(g_, w_, tol)
                check(ok, f"flash backward {name} {shape} {dt}: {err}")
                key = (f"{name}_{str(dt).split('.')[-1]}"
                       + ("" if name == "delta" else f"_{design}"))
                worst[key] = max(worst.get(key, 0.0), err)
            if sq > sk:
                check(bool((dq[:, :sq - sk] == 0).all()),
                      f"rows that see no key got a gradient: {shape}")
            if dt == torch.float32 and sq <= sk:
                leaves = [x.double().requires_grad_() for x in (q, k, v)]
                ref.ref_attention(*leaves).backward(do.double())
                for name, w_, t in zip(("dq", "dk", "dv"), want, leaves):
                    ok, err = within(w_.double(), t.grad,
                                     BWD_TOL[torch.float32])
                    check(ok, f"plain backward {name} {shape} vs f64: {err}")
                    worst[f"plain_vs_f64_{name}"] = max(
                        worst.get(f"plain_vs_f64_{name}", 0.0), err)
                n_f64 += 1
            if layout == "transposed_q":
                # the autograd path, and a scalar loss's zero-stride dO
                leaves = [x.clone().requires_grad_() for x in (q, k, v)]
                kops.flash_attention(*leaves).backward(do)
                check(all(torch.equal(t.grad, g_) for t, g_ in
                          zip(leaves, (dq, dk, dv))),
                      f"FlashAttentionFn's gradients {shape} {dt}")
                leaves = [x.clone().requires_grad_() for x in (q, k, v)]
                kops.flash_attention(*leaves).float().sum().backward()
                ones = torch.ones_like(do)
                want1 = (kops.flash_bwd_dq(q, k, v, ones, lse, kops
                                           .flash_bwd_delta(o, ones)),)
                check(torch.equal(leaves[0].grad, want1[0]),
                      f"a zero-stride dO {shape} {dt}")
            n_cases += 1
    check(cases_by_design == want_by_design
          and all(n > 0 for n in cases_by_design.values()),
          f"cases by design {cases_by_design}, want {want_by_design}")
    emit({"phase": "kernel_edges_train", "cases": n_cases,
          "cases_by_design": cases_by_design,
          "f64_checks": n_f64, "copied_cases": copies,
          "worst_abs_diff": worst, "lse_worst_abs_diff": lse_worst,
          "tol": {"f32": BWD_TOL[torch.float32],
                  "bf16": BWD_TOL[torch.bfloat16], "lse": LSE_TOL}})


@contextlib.contextmanager
def launches_during(kops, acc: dict):
    """Add the launches every kernel (and flash by design) made during
    the block to ``acc``, and leave the counts as they were: work beside
    a path, counted apart."""
    before = {k: (f.launches, dict(getattr(f, "by_design", {})))
              for k, f in kops.KERNELS.items()}
    try:
        yield acc
    finally:
        for k, f in kops.KERNELS.items():
            acc[k] = acc.get(k, 0) + f.launches - before[k][0]
            f.launches = before[k][0]
            for dsg, n in getattr(f, "by_design", {}).items():
                key = f"{k}.{dsg}"
                acc[key] = acc.get(key, 0) + n - before[k][1][dsg]
            if hasattr(f, "by_design"):
                f.by_design.update(before[k][1])


@contextlib.contextmanager
def first_backward_inputs(kept: list):
    """Keep the arguments of the first flash backward of the block (q, k,
    v, o, lse, dO: the last layer's, where the backward starts)."""
    from repro_torch.kernels import flash_attention as fa
    orig = fa.flash_attention_bwd

    def wrapped(*args):
        if not kept:
            kept.append(args)
        return orig(*args)

    fa.flash_attention_bwd = wrapped
    try:
        yield kept
    finally:
        fa.flash_attention_bwd = orig


class PlainFlashFn(torch.autograd.Function):
    """The flash kernels' function through their plain versions on the
    card: forward ``ref_flash_attention`` with its lse, backward
    ``ref_flash_attention_bwd`` (delta from the bf16 o, as the kernels
    read it), on PLAIN_FLASH_TILE tiles; with ``kernel_bwd`` the backward
    is the kernels' (``flash_attention_bwd``) on the plain forward's o
    and lse."""

    @staticmethod
    def forward(ctx, q, k, v, kernel_bwd):
        from repro_torch.kernels import ref
        o, lse = ref.ref_flash_attention(q, k, v, bq=PLAIN_FLASH_TILE,
                                         bk=PLAIN_FLASH_TILE,
                                         return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kernel_bwd = kernel_bwd
        return o

    @staticmethod
    def backward(ctx, do):
        from repro_torch.kernels import flash_attention as fa, ref
        if ctx.kernel_bwd:
            return (*fa.flash_attention_bwd(*ctx.saved_tensors, do), None)
        return (*ref.ref_flash_attention_bwd(*ctx.saved_tensors, do,
                                             bq=PLAIN_FLASH_TILE,
                                             bk=PLAIN_FLASH_TILE), None)


@contextlib.contextmanager
def plain_flash_attention(kernel_bwd: bool = False):
    """The attention module's flash calls go to PlainFlashFn for the
    block: the chunked path with no flash kernel (a witness beside the
    kernels' run), or with the backward kernels alone."""
    from repro_torch.models import attention as A
    orig = A.flash_attention
    A.flash_attention = lambda q, k, v: PlainFlashFn.apply(q, k, v,
                                                           kernel_bwd)
    try:
        yield
    finally:
        A.flash_attention = orig


def lm_batch(rng, vocab: int, b: int, s: int) -> dict:
    toks = rng.integers(3, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def phase_train(kops, seed: int, root: str) -> dict:
    """llama3.2-1b at the published dims through ``Trainer.run_loop`` on
    the card: TRAIN_STEPS steps on one repeated batch of TRAIN_BATCH x
    TRAIN_SEQ, the last under torch.profiler; then chunked against xla
    (``phase_train_parity``) and delta checkpoints
    (``phase_train_checkpoint``)."""
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.train.train_loop import Trainer, TrainerConfig
    cfg = get_config(ARCH)
    run = RunConfig()
    # the launcher's rule at this length
    check(run.attn_impl == ("xla" if TRAIN_SEQ <= 2048 else "chunked"),
          f"RunConfig().attn_impl {run.attn_impl}")
    rec = {"phase": "train", "arch": ARCH, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "params": cfg.param_count(),
           "dtype": cfg.dtype, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "steps": TRAIN_STEPS, "optimizer": run.optimizer,
           "remat": run.remat, "attn_impl": run.attn_impl}
    rng = np.random.default_rng(seed)
    batch = lm_batch(rng, cfg.vocab, TRAIN_BATCH, TRAIN_SEQ)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr, rec["init_s"] = wall(lambda: Trainer(
        cfg, run, TrainerConfig(total_steps=TRAIN_STEPS), seed=seed))
    walls, kept = [], []
    t_prev = [0.0]

    def hook(step, m):
        sync()
        now = time.perf_counter()
        walls.append(now - t_prev[0])
        t_prev[0] = now

    reset_counts(kops)
    with first_backward_inputs(kept):
        sync()
        t_prev[0] = time.perf_counter()
        tr.run_loop(iter([batch] * (TRAIN_STEPS - 1)), hook=hook)
        rec["profile"] = device_profile(
            lambda: tr.run_loop(iter([batch])))
    counts = read_counts(kops)
    rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    fa = kops.flash_attention
    rec["launches"] = {k: counts[k] for k in PATH_KERNELS["train"]}
    rec["flash_launches_by_design"] = dict(fa.by_design)
    losses = [m["loss"] for m in tr.history]
    rec.update(losses=losses,
               grad_norms=[m["grad_norm"] for m in tr.history],
               step_walls_s=walls, step_wall_median_s=float(np.median(walls)),
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / float(np.median(walls)))
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
          f"train losses {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    per = cfg.n_layers * TRAIN_STEPS
    check(fa.by_design["wgmma"] == 2 * per and fa.launches == 2 * per,
          f"flash forward launches {fa.by_design} (want {2 * per} wgmma: "
          f"a forward and a remat recompute per layer and step)")
    for k in ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq"):
        check(counts[k] == per, f"{k}: {counts[k]} launches, want {per}")
    rec["bwd_launches_by_design"] = {
        k: dict(getattr(kops, k).by_design)
        for k in ("flash_bwd_dkdv", "flash_bwd_dq")}
    for k, by in rec["bwd_launches_by_design"].items():
        check(by["wgmma"] == per == counts[k],
              f"{k}: launches by design {by}, want all {per} wgmma")
    for k in PATH_KERNELS["train"]:
        check(counts[k] > 0, f"train path did not launch {k}")
    rec["backward_inputs"] = [list(x.shape) for x in kept[0]]
    emit(rec)
    del tr
    torch.cuda.empty_cache()
    parity = phase_train_parity(kops, cfg, run, seed)
    ckpt = phase_train_checkpoint(kops, cfg, seed, root)
    # the kernels line's rows of this phase: the forward at the train
    # shape is the path's flash launches; the D 128 backward rows no path's
    no_path = {f"flash_bwd_{k}{sfx}": 0 for k in ("delta", "dkdv", "dq")
               for sfx in ("_d128", "_d128_f32")}
    return {"launches": {**rec["launches"], **parity["f32_launches"],
                         "flash_attention_train":
                         rec["launches"]["flash_attention"], **no_path},
            "bwd_inputs": kept[0], "checkpoint": ckpt}


def tree_norm(grads) -> float:
    from repro_torch.train.tree import tree_leaves
    return math.sqrt(sum(float((g.float() ** 2).sum())
                         for g in tree_leaves(grads)))


def phase_train_parity(kops, cfg, run, seed: int) -> dict:
    """Chunked against xla on the same parameters and batch: the full
    model in bf16 at B TRAIN_BATCH x PARITY_SEQ (loss, gradient norm and
    each layer's wq, wk and wv gradients within PARITY_TOL_BF16), then a
    full-width
    copy of its first PARITY_F32_LAYERS layers in f32 (loss, norm and
    every gradient leaf within PARITY_TOL_F32). The chunked f32 run's
    launches are the f32 backward rows' (every flash forward on
    wgmma_f32, every dkdv and dq on the f32 backward's wgmma_f32)."""
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import FwdOpts, build
    from repro_torch.train.tree import leaves_with_path
    rng = np.random.default_rng(seed + 1)
    batch = {k: torch.as_tensor(v, device=DEV) for k, v in
             lm_batch(rng, cfg.vocab, TRAIN_BATCH, PARITY_SEQ).items()}
    rec = {"phase": "train_parity", "batch": TRAIN_BATCH,
           "seq": PARITY_SEQ, "layers": cfg.n_layers}

    def grads(c, params, impl):
        return value_and_grad(lambda p: build(c).loss(
            p, batch, FwdOpts(attn_impl=impl, remat=run.remat)), params)

    params = build(cfg).init(seed + 1, device=DEV)
    acc: dict = {}
    with launches_during(kops, acc):
        (lx, _), gx = grads(cfg, params, "xla")
        (lc, _), gc = grads(cfg, params, "chunked")
    check(acc["flash_attention.wgmma"] == 2 * cfg.n_layers
          and acc["flash_bwd_dq"] == cfg.n_layers
          and acc["flash_bwd_dq.wgmma"] == acc["flash_bwd_dkdv.wgmma"]
          == cfg.n_layers, f"launches {acc}")
    nx, nc = tree_norm(gx), tree_norm(gc)
    rel = {w: [float((a["attn"][w].float() - b["attn"][w].float()).abs()
                     .max() / b["attn"][w].float().abs().max())
               for a, b in zip(gc["layers"], gx["layers"])]
           for w in ("wq", "wk", "wv")}
    rec["bf16"] = {"loss_xla": float(lx), "loss_chunked": float(lc),
                   "grad_norm_xla": nx, "grad_norm_chunked": nc,
                   **{f"{w}_rel_max": r for w, r in rel.items()},
                   "tol": PARITY_TOL_BF16}
    check(abs(float(lc) - float(lx)) <= PARITY_TOL_BF16["loss"] * abs(
        float(lx)) and abs(nc - nx) <= PARITY_TOL_BF16["grad_norm"] * nx
          and all(max(r) <= PARITY_TOL_BF16[w] for w, r in rel.items()),
          f"bf16 chunked against xla: {rec['bf16']}")
    del gx, gc
    c32 = dataclasses.replace(cfg, n_layers=PARITY_F32_LAYERS,
                              dtype="float32")
    p32 = {"embed": {k: v.float() for k, v in params["embed"].items()},
           "final_norm": dict(params["final_norm"]),
           "layers": [{k: {n: t.float() for n, t in sub.items()}
                       for k, sub in lay.items()}
                      for lay in params["layers"][:PARITY_F32_LAYERS]]}
    del params
    (lx, _), gx = uncounted(kops, lambda: grads(c32, p32, "xla"))
    f32: dict = {}
    with launches_during(kops, f32):
        (lc, _), gc = grads(c32, p32, "chunked")
    check(f32["flash_attention.wgmma_f32"] == 2 * PARITY_F32_LAYERS
          and f32["flash_attention"] == 2 * PARITY_F32_LAYERS
          and f32["flash_bwd_dkdv.wgmma_f32"] == f32["flash_bwd_dq.wgmma_f32"]
          == f32["flash_bwd_dkdv"] == f32["flash_bwd_dq"]
          == PARITY_F32_LAYERS, f"f32 chunked launches {f32}")
    worst = 0.0
    for (path, a), (_, b) in zip(leaves_with_path(gc), leaves_with_path(gx)):
        err = float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
        worst = max(worst, err)
    nx, nc = tree_norm(gx), tree_norm(gc)
    rec["f32"] = {"layers": PARITY_F32_LAYERS, "loss_xla": float(lx),
                  "loss_chunked": float(lc), "grad_norm_xla": nx,
                  "grad_norm_chunked": nc, "worst_leaf_rel": worst,
                  "tol": PARITY_TOL_F32,
                  "launches": {k: f32[k] for k in
                               ("flash_attention.wgmma_f32", "flash_bwd_delta",
                                "flash_bwd_dkdv", "flash_bwd_dq",
                                "flash_bwd_dkdv.wgmma_f32",
                                "flash_bwd_dq.wgmma_f32")}}
    check(abs(float(lc) - float(lx)) <= PARITY_TOL_F32 * abs(float(lx))
          and abs(nc - nx) <= PARITY_TOL_F32 * nx
          and worst <= PARITY_TOL_F32, f"f32 chunked against xla: "
          f"{rec['f32']}")
    emit(rec)
    return {"f32_launches": {f"{k}_f32": f32[k] for k in
                             ("flash_bwd_delta", "flash_bwd_dkdv",
                              "flash_bwd_dq")}}


def phase_train_checkpoint(kops, cfg, seed: int, root: str) -> dict:
    """Delta checkpoints of llama3.2-1b cut to CKPT_DIMS (at full width
    the host's deflate of each save's 1.3 GB of f32 rows alone outlasts
    this script's budget; tools/torch_train_ckpt_probe.py times that
    save): a Trainer with ckpt_every=1 saves two steps into a
    VersionedStore on the card; each step's restore equals the
    parameters it saved bit for bit, in their dtype, on the card, and so
    does a fresh CheckpointManager opened on the directory. Walls (the
    caller's save, the store update, the persistence), stats() and the
    launches of the store's kernels."""
    from repro_torch.configs import RunConfig
    from repro_torch.ft.checkpoint import CheckpointManager
    from repro_torch.train.train_loop import Trainer, TrainerConfig
    from repro_torch.train.tree import tree_leaves
    c1 = dataclasses.replace(cfg, **CKPT_DIMS)
    d = os.path.join(root, "ckpt")
    rec = {"phase": "train_checkpoint", "dims": CKPT_DIMS,
           "reduced": {k: [getattr(cfg, k), v] for k, v in CKPT_DIMS.items()
                       if getattr(cfg, k) != v},
           "params": c1.param_count(), "seq": CKPT_SEQ}
    batch = lm_batch(np.random.default_rng(seed + 2), c1.vocab,
                     TRAIN_BATCH, CKPT_SEQ)
    tr = Trainer(c1, RunConfig(), TrainerConfig(
        total_steps=2, ckpt_every=1, ckpt_dir=d), seed=seed)
    saved = {}

    def hook(step, m):  # the trainer has just saved this step's params
        saved[step] = [t.clone() for t in tree_leaves(tr.state["params"])]

    walls: dict = {}
    reset_counts(kops)
    with timed_calls(tr.ckpt, "save", walls, key=lambda a, k: f"save_{a[0]}"), \
            timed_calls(tr.ckpt, "_persist", walls), \
            timed_calls(tr.ckpt.store, "update", walls):
        _, rec["run_s"] = wall(lambda: tr.run_loop(iter([batch] * 2),
                                                   hook=hook))
    save_counts = read_counts(kops)
    rec["save_walls_s"] = walls
    rec["stats"] = tr.ckpt.stats()
    rec["store_rows"] = tr.ckpt.store.n_rows
    check(tr.ckpt.steps() == [1, 2], f"steps {tr.ckpt.steps()}")
    like = tr.state["params"]
    restore_s = {}
    for name, cm in (("same", tr.ckpt), ("reopened", None)):
        if cm is None:
            cm, restore_s["open"] = wall(lambda: CheckpointManager(d))
        for step in (1, 2):
            got, restore_s[f"{name}_{step}"] = wall(
                lambda: cm.restore(step, like=like))
            check(all(a.dtype == b.dtype and a.device == b.device
                      and torch.equal(a, b) for a, b in
                      zip(tree_leaves(got), saved[step])),
                  f"{name} restore of step {step} differs from the save")
            del got
    counts = read_counts(kops)
    rec["restore_walls_s"] = restore_s
    rec["launches_saves"] = {k: save_counts[k] for k in (
        "fingerprint", "masked_cumsum", "delta_pack", "chain_decode")}
    rec["launches"] = {k: counts[k] for k in (
        "fingerprint", "masked_cumsum", "delta_pack", "chain_decode")}
    rec["disk_bytes"] = sum(os.path.getsize(os.path.join(p, n))
                            for p, _, names in os.walk(d) for n in names)
    for k in PATH_KERNELS["train_checkpoint"]:
        check(counts[k] > 0, f"checkpoint path did not launch {k}")
    del tr, saved
    torch.cuda.empty_cache()
    emit(rec)
    return rec


def phase_kernel_train(bench: KernelBench, train_out, seed: int) -> None:
    """The backward kernels at the train path's shape, timed: the first
    backward's inputs of the first step (the last layer's q, k, v, o and
    lse) with a seeded unit-scale dO in bf16, and the same values in f32
    with o and lse from the f32 forward, each held ``scaled`` (the step's
    own dO, from a mean over 8,192 tokens, gives gradients of 1e-6 to
    8e-5, under BWD_TOL's atol; the kernels' work does not depend on dO's
    values, so the times are the path's); the bf16 forward on those q, k,
    v with the lse written (flash_attention_train, with lse_rounds); then
    the backward at olmo-1b's attention (BWD_D128_HEADS) on seeded inputs,
    in bf16 and f32, launched by no path."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, o, lse, _ = (x.detach() for x in train_out.pop("bwd_inputs"))
    gen = torch.Generator(device=DEV).manual_seed(seed + 36)
    do = torch.randn(q.shape, generator=gen, device=DEV).to(q.dtype)
    bench.flash_bwd(q, k, v, o, lse, do, scaled=True)
    bench.flash(q, k, v, main=True, reps=3, name="flash_attention_train",
                device=True, lse=True)
    bench.main["flash_attention_train"].update(lse_rounds(bench, q, k, v))
    q, k, v, do = (x.float() for x in (q, k, v, do))
    o, lse = fa._forward(q, k, v, lse=True)
    bench.flash_bwd(q, k, v, o, lse, do, suffix="_f32", scaled=True)
    del q, k, v, o, lse, do
    torch.cuda.empty_cache()
    h, kh, d = BWD_D128_HEADS
    gen = torch.Generator(device=DEV).manual_seed(seed + 5)
    for dt, suffix in ((torch.bfloat16, "_d128"), (torch.float32,
                                                   "_d128_f32")):
        q, k, v, do = bwd_inputs(gen, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, h,
                                 kh, d, "contiguous", dt)
        o, lse = fa._forward(q, k, v, lse=True)
        bench.flash_bwd(q, k, v, o, lse, do, suffix=suffix, scaled=True)
        del q, k, v, o, lse, do
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# families_train: kimi-k2's attention trained at its published widths, and
# every family's smoke config trained on the CPU and the card
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def captured_grads(out: list):
    """Keep a copy of the gradients of every ``value_and_grad`` call that
    a train step makes during the block (``launch/steps.py``'s, before
    clipping and the optimizer)."""
    from repro_torch.launch import steps
    from repro_torch.train.tree import tree_map
    orig = steps.value_and_grad

    def wrapped(fn, params):
        res = orig(fn, params)
        out.append(tree_map(lambda g: g.detach().clone(), res[1]))
        return res

    steps.value_and_grad = wrapped
    try:
        yield out
    finally:
        steps.value_and_grad = orig


def smoke_train_batch(cfg, seed: int) -> dict:
    """One host batch of FT_SMOKE_BATCH x FT_SMOKE_SEQ tokens for a smoke
    config's train step, from numpy: token ids and shifted labels (a few
    masked), qwen2-vl's embeddings and M-RoPE positions in their place,
    whisper's frame embeddings beside its tokens."""
    b, s = FT_SMOKE_BATCH, FT_SMOKE_SEQ
    rng = np.random.default_rng(seed)
    toks = rng.integers(3, cfg.vocab, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    batch["labels"][0, :3] = -100
    if cfg.input_mode == "embeddings":
        gen = torch.Generator().manual_seed(seed)
        del batch["tokens"]
        batch.update({k: v.numpy() for k, v in vlm_inputs(
            cfg, b, s, gen, torch.float32).items()})
    if cfg.family == "encdec":
        batch["enc_embeds"] = whisper_frames(cfg, b, seed, "cpu",
                                             torch.float32).numpy()
    return batch


def family_train_smoke(kops, arch: str, seed: int) -> dict:
    """One Trainer step (RunConfig() defaults: AdamW, chunked, remat) of a
    smoke config in f32 on device="cpu" and on the card, from one
    ``weights.random_tree``: the losses within SMOKE_TOL and every
    gradient leaf within FAMILY_GRAD_TOL; the card step's launches (the
    counts set to 0 just before it), its flash calls by design and head
    dim, and the backward's launches by design, which must be the
    mma_f32 kernels' (one delta, dkdv and dq an attention layer; the
    forward twice, remat's recomputation), and no scan kernel's (the
    training forward runs the Mamba and RWKV scans as torch ops)."""
    from repro_torch.configs import RunConfig, get_smoke_config
    from repro_torch.models import weights
    from repro_torch.train.train_loop import Trainer, TrainerConfig
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    tree = weights.random_tree(cfg, np.random.default_rng(seed + 31))
    batch = smoke_train_batch(cfg, seed + 32)
    res = {}
    for dev in ("cpu", DEV):
        params = weights.from_jax_tree(cfg, tree, device=dev)
        tr = Trainer(cfg, RunConfig(), TrainerConfig(total_steps=1),
                     params=params, device=dev)
        got: list = []
        counted = flash_calls() if dev == DEV else contextlib.nullcontext()
        if dev == DEV:
            reset_counts(kops)
        with captured_grads(got), counted as calls:
            tr.run_loop(iter([batch]))
        if dev == DEV:
            launches = {k: v for k, v in read_counts(kops).items() if v}
            by_design = {k: {d: n for d, n in getattr(kops, k).by_design
                             .items() if n}
                         for k in ("flash_attention", "flash_bwd_dkdv",
                                   "flash_bwd_dq")}
        (grads,) = got
        res[dev] = (tr.history[0]["loss"], weights.to_jax_tree(cfg, grads))
        del tr, params, grads
    (lc, gc), (lg, gg) = res["cpu"], res[DEV]
    atol, rtol = FAMILY_GRAD_TOL
    worst, worst_leaf = 0.0, None
    for (path, a), (_, g) in zip(_jax_leaves(gc), _jax_leaves(gg)):
        e = float(np.abs(a - g).max(initial=0.0)) / (
            atol + rtol * float(np.abs(a).max(initial=0.0)))
        if e > worst:
            worst, worst_leaf = e, path
    n_fwd = sum(calls["by_dim"].values())
    n_bwd = launches.get("flash_bwd_dkdv", 0)
    out = {"config": cfg.name, "head_dim": cfg.hd, "loss_cpu": lc,
           "loss_card": lg, "loss_diff": abs(lc - lg),
           "loss_tol": SMOKE_TOL, "grad_err_in_tol": worst,
           "worst_leaf": worst_leaf, "grad_tol": FAMILY_GRAD_TOL,
           "launches": launches, "flash_calls_by_dim": calls["by_dim"],
           "launches_by_design": by_design}
    check(abs(lc - lg) <= SMOKE_TOL, f"{arch} smoke train: loss {lg} on "
                                     f"the card, {lc} on the cpu")
    # the training forward runs the scans' chunked torch ops: no scan
    # kernel launches in a train step
    check("ssm_scan" not in launches and "wkv" not in launches,
          f"{arch} smoke train launched a scan kernel: {launches}")
    check(worst <= 1.0, f"{arch} smoke train: gradient {worst_leaf} "
                        f"{worst} x its tolerance")
    want_fwd = ({} if cfg.rwkv else {f"mma_f32<{cfg.hd}>": n_fwd})
    check(calls["by_dim"] == want_fwd and n_fwd == 2 * n_bwd
          and launches.get("flash_attention", 0) == n_fwd
          and all(launches.get(k, 0) == n_bwd for k in
                  ("flash_bwd_delta", "flash_bwd_dq"))
          and (cfg.rwkv or n_bwd > 0)
          and by_design["flash_bwd_dkdv"] == by_design["flash_bwd_dq"]
          == ({"mma_f32": n_bwd} if n_bwd else {}),
          f"{arch} smoke train launches {launches}, calls "
          f"{calls['by_dim']}, by design {by_design}")
    return out


def kimi_smoke_bf16_parity(kops, seed: int) -> dict:
    """kimi-k2's smoke config in bf16 on the card (D 16: the bf16 mma
    backward on a path), chunked against xla on the same parameters and
    batch (RunConfig()'s remat): loss, gradient norm and each layer's wq,
    wk and wv gradients within SMOKE_PARITY_TOL_BF16; the chunked run's
    flash launches, every backward on the mma design."""
    from repro_torch.configs import RunConfig, get_smoke_config
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import FwdOpts, build
    cfg = get_smoke_config(FT_ARCH)
    params = build(cfg).init(seed + 33, device=DEV)
    batch = {k: torch.as_tensor(v, device=DEV) for k, v in lm_batch(
        np.random.default_rng(seed + 34), cfg.vocab, FT_SMOKE_BATCH,
        FT_SMOKE_SEQ).items()}
    remat = RunConfig().remat

    def grads(impl):
        return value_and_grad(lambda p: build(cfg).loss(
            p, batch, FwdOpts(attn_impl=impl, remat=remat)), params)

    (lx, _), gx = uncounted(kops, lambda: grads("xla"))
    acc: dict = {}
    with launches_during(kops, acc):
        (lc, _), gc = grads("chunked")
    nx, nc = tree_norm(gx), tree_norm(gc)
    rel = {w: [float((a["attn"][w].float() - b["attn"][w].float()).abs()
                     .max() / b["attn"][w].float().abs().max())
               for a, b in zip(gc["layers"], gx["layers"])]
           for w in ("wq", "wk", "wv")}
    n = cfg.n_layers
    out = {"config": cfg.name, "dtype": cfg.dtype, "head_dim": cfg.hd,
           "loss_xla": float(lx), "loss_chunked": float(lc),
           "grad_norm_xla": nx, "grad_norm_chunked": nc,
           **{f"{w}_rel_max": r for w, r in rel.items()},
           "tol": SMOKE_PARITY_TOL_BF16,
           "launches": {k: v for k, v in acc.items() if v}}
    tol = SMOKE_PARITY_TOL_BF16
    check(abs(float(lc) - float(lx)) <= tol["loss"] * abs(float(lx))
          and abs(nc - nx) <= tol["grad_norm"] * nx
          and all(max(r) <= tol[w] for w, r in rel.items()),
          f"kimi-k2-smoke bf16 chunked against xla: {out}")
    check(acc.get("flash_attention.mma") == 2 * n
          and acc.get("flash_bwd_dkdv.mma") == acc.get("flash_bwd_dq.mma")
          == acc.get("flash_bwd_dkdv") == acc.get("flash_bwd_delta") == n,
          f"kimi-k2-smoke bf16 launches {acc}")
    return out


def kimi_parity(kops, cfg, params, batch, remat: str) -> dict:
    """One loss and gradient of ``cfg`` on the same parameters and batch
    four ways: ``xla``; ``chunked`` through the kernels; ``plain``, the
    chunked path through the kernels' plain versions (PlainFlashFn, no
    launch); ``kernel_bwd``, the plain forward with the backward kernels.
    Each pair that a check reads, apart by ``apart``'s measures, the
    losses, norms and walls, and each way's launches (counted apart)."""
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import FwdOpts, build
    tb = {k: torch.as_tensor(v, device=DEV) for k, v in batch.items()}
    ways: dict = {}
    acc: dict = {}
    for way in ("xla", "chunked", "plain", "kernel_bwd"):
        acc[way] = {}
        with launches_during(kops, acc[way]), (
                plain_flash_attention(kernel_bwd=way == "kernel_bwd")
                if way in ("plain", "kernel_bwd")
                else contextlib.nullcontext()):
            ((loss, _), g), s = wall(lambda: value_and_grad(
                lambda p: build(cfg).loss(p, tb, FwdOpts(
                    attn_impl="xla" if way == "xla" else "chunked",
                    remat=remat)), params))
        ways[way] = (float(loss), tree_norm(g), {
            w: g["layers"][0]["attn"][w].float() for w in ("wq", "wk", "wv")},
            s)
        del g
        torch.cuda.empty_cache()

    def apart(a, b) -> dict:
        """a's loss, norm and wq / wk / wv gradients against b's: relative
        to b's loss and norm, to each gradient's largest magnitude (rel)
        and its L2 norm (rel_l2)."""
        (la, na, wa, _), (lb, nb, wb, _) = ways[a], ways[b]
        return {"loss": abs(la - lb) / abs(lb), "grad_norm": abs(na - nb) / nb,
                **{f"{w}_rel": float((wa[w] - wb[w]).abs().max()
                                     / wb[w].abs().max()) for w in wb},
                **{f"{w}_rel_l2": float((wa[w] - wb[w]).norm()
                                        / wb[w].norm()) for w in wb}}

    return {**{f"{k}_{i}": ways[i][n] for i in ways
               for n, k in ((0, "loss"), (1, "grad_norm"), (3, "wall_s"))},
            **{f"{a}_vs_{b}": apart(a, b) for a, b in (
                ("chunked", "xla"), ("plain", "xla"), ("chunked", "plain"),
                ("kernel_bwd", "plain"))},
            "tol": {"chunked_vs_xla": PARITY_TOL_BF16,
                    "kernel_bwd_vs_plain": KIMI_BWD_TOL_BF16},
            "launches": {w: {k: n for k, n in c.items() if n}
                         for w, c in acc.items()}}


def phase_families_train(kops, seed: int) -> dict:
    """Training the families on the card. kimi-k2 at its published widths
    (d 7,168, 64 / 8 heads of 112, 64 of its 384 experts of 2,048, vocab
    163,840, top-8, capacity 1.25; FT_LAYERS layer), initialised on the
    card from the seed, Adafactor, B FT_BATCH x FT_SEQ: first
    kimi_parity on the same parameters and batch, chunked against xla
    (loss, gradient norm and the relative L2 distance of the layer's wq,
    wk and wv gradients within PARITY_TOL_BF16; their largest-element
    distance beside) and the backward kernels against their plain version
    on the plain forward (within KIMI_BWD_TOL_BF16), then FT_STEPS Trainer
    steps, the last under torch.profiler: losses, step
    walls, tokens/s, peak memory, the idle share, and the flash launches
    by design and head dim, each step a forward and a remat recompute on
    wgmma<112> and one delta, dkdv and dq on the wgmma (D 112) backward.
    Then the nine FAMILY_SMOKE configs in f32, one Trainer step each on
    the CPU and the card (family_train_smoke), and kimi-k2's smoke config
    in bf16 on the card, chunked against xla (kimi_smoke_bf16_parity)."""
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.models import build
    from repro_torch.train.train_loop import Trainer, TrainerConfig
    full = family_cfg(FT_ARCH, FT_LAYERS)
    cfg = dataclasses.replace(full, n_experts=FT_EXPERTS)
    run = RunConfig(optimizer="adafactor")
    # the launcher's rule at this length (launch/train.py)
    check(run.attn_impl == ("xla" if FT_SEQ <= 2048 else "chunked"),
          f"RunConfig().attn_impl {run.attn_impl}")
    rec = {"phase": "families_train", "arch": FT_ARCH,
           "reduced": {"n_layers": [get_config(FT_ARCH).n_layers,
                                    FT_LAYERS],
                       "n_experts": [full.n_experts, FT_EXPERTS]},
           "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
           "head_dim": cfg.hd, "vocab": cfg.vocab, "top_k": cfg.top_k,
           "d_ff_expert": cfg.d_ff_expert,
           "capacity_factor": cfg.capacity_factor, "dtype": cfg.dtype,
           "batch": FT_BATCH, "seq": FT_SEQ, "steps": FT_STEPS,
           "optimizer": run.optimizer, "remat": run.remat,
           "attn_impl": run.attn_impl}
    batch = lm_batch(np.random.default_rng(seed + 30), cfg.vocab, FT_BATCH,
                     FT_SEQ)
    torch.cuda.empty_cache()
    reset_peak()
    params, rec["init_s"] = wall(lambda: build(cfg).init(seed + 30,
                                                         device=DEV))
    rec["params"], rec["param_bytes"] = tree_sizes(params)
    rec["parity"] = kimi_parity(kops, cfg, params, batch, run.remat)
    rec["parity_peak_memory_bytes"] = peak_bytes()
    par = rec["parity"]
    # PARITY_TOL_BF16 on the loss, the norm and each gradient's relative
    # L2 distance; by the largest element the plain witness reads a spread
    # of that size too (PERF.md)
    tol, vs_xla = PARITY_TOL_BF16, par["chunked_vs_xla"]
    check(vs_xla["loss"] <= tol["loss"]
          and vs_xla["grad_norm"] <= tol["grad_norm"]
          and all(vs_xla[f"{w}_rel_l2"] <= tol[w] for w in ("wq", "wk", "wv")),
          f"kimi-k2 chunked against xla: {par}")
    check(all(par["kernel_bwd_vs_plain"][k] <= t
              for k, t in KIMI_BWD_TOL_BF16.items()),
          f"kimi-k2 backward kernels against their plain version: {par}")
    acc = par["launches"]
    check(acc["chunked"].get("flash_attention.wgmma") == 2 * FT_LAYERS
          and acc["chunked"].get("flash_bwd_dkdv.wgmma")
          == acc["chunked"].get("flash_bwd_dq.wgmma") == FT_LAYERS
          and not acc["plain"]
          and acc["kernel_bwd"] == {k: FT_LAYERS for k in (
              "flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dkdv.wgmma",
              "flash_bwd_dq", "flash_bwd_dq.wgmma")},
          f"kimi-k2 parity launches {acc}")
    # FT_STEPS Trainer steps on the same parameters, from an emptied cache
    # (the step's peak is within 11 GB of the card's memory)
    gc.collect()
    torch.cuda.empty_cache()
    tr = Trainer(cfg, run, TrainerConfig(total_steps=FT_STEPS),
                 params=params, device=DEV)
    del params
    walls, kept, t_prev = [], [], [0.0]

    def hook(step, m):
        sync()
        now = time.perf_counter()
        walls.append(now - t_prev[0])
        t_prev[0] = now

    reset_counts(kops)
    reset_peak()
    with first_backward_inputs(kept), flash_calls() as calls:
        sync()
        t_prev[0] = time.perf_counter()
        tr.run_loop(iter([batch] * (FT_STEPS - 1)), hook=hook)
        rec["profile"] = device_profile(lambda: tr.run_loop(iter([batch])))
    counts = read_counts(kops)
    rec["peak_memory_bytes"] = peak_bytes()
    losses = [m["loss"] for m in tr.history]
    rec.update(losses=losses,
               grad_norms=[m["grad_norm"] for m in tr.history],
               step_walls_s=walls, step_wall_median_s=float(np.median(walls)),
               tokens_per_s=FT_BATCH * FT_SEQ / float(np.median(walls)),
               idle_share=rec["profile"].get("idle_share"),
               launches={k: counts[k] for k in PATH_KERNELS["train"]},
               flash_calls_by_dim=calls["by_dim"],
               flash_launches_by_design={
                   k: dict(getattr(kops, k).by_design)
                   for k in ("flash_attention", "flash_bwd_dkdv",
                             "flash_bwd_dq")})
    check(len(losses) == FT_STEPS and all(map(math.isfinite, losses)),
          f"kimi-k2 train losses {losses}")
    per = FT_LAYERS * FT_STEPS
    check(calls["by_dim"] == {"wgmma<112>": 2 * per}
          and kops.flash_attention.by_design["wgmma"] == 2 * per
          and counts["flash_attention"] == 2 * per,
          f"kimi-k2 flash forward {calls['by_dim']} (want {2 * per} "
          f"wgmma<112>: a forward and a remat recompute a step)")
    for k in ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq"):
        check(counts[k] == per, f"kimi-k2 {k}: {counts[k]}, want {per}")
    for k in ("flash_bwd_dkdv", "flash_bwd_dq"):
        check(getattr(kops, k).by_design["wgmma"] == per,
              f"kimi-k2 {k} by design {getattr(kops, k).by_design}")
    del tr
    torch.cuda.empty_cache()
    # the smoke configs, CPU against the card, and kimi-k2's in bf16
    t0 = time.perf_counter()
    smoke = {arch: family_train_smoke(kops, arch, seed)
             for arch in FAMILY_SMOKE}
    rec["smoke_f32"] = smoke
    rec["smoke_bf16"] = kimi_smoke_bf16_parity(kops, seed)
    rec["smoke_s"] = time.perf_counter() - t0
    d8 = smoke["qwen2-0.5b"]["launches"].get("flash_bwd_dkdv", 0)
    check(d8 > 0 and smoke["qwen2-0.5b"]["head_dim"] == 8,
          "qwen2-0.5b-smoke: no mma_f32 backward at D 8")
    check(not smoke["rwkv6-7b"]["flash_calls_by_dim"],
          "rwkv6-7b-smoke launched flash attention")
    emit(rec)
    # the kernels line's rows of this phase's path: the D 112 backward
    # (kimi-k2's steps), the f32 mma backward at D 16 (the smoke steps),
    # the bf16 one at D 16 (kimi-k2-smoke's chunked run); at D 32 no path
    d16_f32 = {k: sum(one["launches"].get(f"flash_bwd_{k}", 0)
                      for one in smoke.values() if one["head_dim"] == 16)
               for k in ("delta", "dkdv", "dq")}
    launches = {}
    for k in ("delta", "dkdv", "dq"):
        launches[f"flash_bwd_{k}_d112"] = counts[f"flash_bwd_{k}"]
        launches[f"flash_bwd_{k}_d16_f32"] = d16_f32[k]
        launches[f"flash_bwd_{k}_d16"] = rec["smoke_bf16"]["launches"].get(
            f"flash_bwd_{k}", 0)
        launches[f"flash_bwd_{k}_d32"] = 0
        launches[f"flash_bwd_{k}_d32_f32"] = 0
    return {"launches": launches, "bwd_inputs": kept[0]}


def phase_kernel_families_train(bench: KernelBench, ft_out,
                                seed: int) -> None:
    """The D 112 backward at kimi-k2's training shape (B 1 x S 4,096, H 64
    / K 8): the q, k, v, o and lse of the families_train steps' first
    backward (the one layer's) and a seeded unit-scale dO. The step's own
    dO comes from a mean over 4,096 tokens: gradients of about 1e-5,
    under BWD_TOL's atol."""
    q, k, v, o, lse, _ = (x.detach() for x in ft_out.pop("bwd_inputs"))
    gen = torch.Generator(device=DEV).manual_seed(seed + 35)
    do = torch.randn(q.shape, generator=gen, device=DEV).to(q.dtype)
    bench.flash_bwd(q, k, v, o, lse, do, suffix="_d112", scaled=True)
    del q, k, v, o, lse, do
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# distributed: the sharded train step, sequence-parallel attention, the
# sharded MoE, the cross-pod mean and elastic restore, one process a rank
# ---------------------------------------------------------------------------

def dist_layout(n_cards: int) -> tuple[int, dict]:
    """(ranks, {run: mesh shape}), fixed by the card count alone.
    tools/torch_dist_probe.py found that ranks cannot share one card over
    gloo (a DTensor gathered whole over both mesh dims kills the ranks),
    so each rank has a card of its own: 4 NCCL ranks from 4 cards up,
    else one NCCL rank on (1, 1) meshes."""
    if n_cards >= 4:
        return 4, {"llama": (2, 2), "qwen": (1, 4), "moe": (2, 2),
                   "pod": (2, 2), "elastic_to": 2}
    return 1, {"llama": (1, 1), "qwen": (1, 1), "moe": (1, 1),
               "pod": (1, 1), "elastic_to": 1}


def full(x):
    """A DTensor gathered whole (every rank of its mesh calls this), or
    ``x`` as it is."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def rel_err(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def dist_steps(kops, arch: str, mesh_shape: tuple, steps: int, seed: int,
               record: bool = False) -> dict:
    """``steps`` train steps of ``arch`` at its published widths (bf16,
    RunConfig() defaults: AdamW, chunked, nothing_saveable remat) at
    TRAIN_BATCH x TRAIN_SEQ on this rank's card: first unsharded, then
    sharded by the rules on a ("data", "model") mesh of ``mesh_shape``,
    from the same weights and batch. Losses and gradient norms side by
    side, each sharded step's wall, the rank's peak memory in the
    sharded run and its kernel launches; ``record``: the last sharded
    step under the collective recorder."""
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.launch.mesh import _mesh
    from repro_torch.launch.roofline import collective_recorder
    from repro_torch.launch.steps import default_hyper, make_train_step
    from repro_torch.models.model import init_params, model_spec
    from repro_torch.sharding import (distribute_tree, shard_batch_specs,
                                      tree_shardings, use_mesh)
    from repro_torch.sharding.rules import distribute
    from repro_torch.train.optimizer import init_state, state_specs
    cfg, run = get_config(arch), RunConfig()
    hyper = default_hyper(cfg, run)
    step = make_train_step(cfg, run, hyper)
    params = init_params(cfg, seed, DEV)
    batch = {k: torch.as_tensor(v, device=DEV) for k, v in lm_batch(
        np.random.default_rng(seed), cfg.vocab, TRAIN_BATCH,
        TRAIN_SEQ).items()}
    rec = {"arch": arch, "mesh": list(mesh_shape), "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "steps": steps, "optimizer": run.optimizer,
           "attn_impl": run.attn_impl, "remat": run.remat}
    state = {"params": params, "opt": init_state(params, hyper)}
    ref = []
    for _ in range(steps):
        state, m = step(state, batch)
        ref.append((float(m["loss"]), float(m["grad_norm"])))
    del state, m
    torch.cuda.empty_cache()
    mesh = _mesh("cuda", mesh_shape, ("data", "model"))
    spec = model_spec(cfg)
    dstate = {"params": distribute_tree(params, tree_shardings(spec, mesh)),
              "opt": distribute_tree(init_state(params, hyper),
                                     tree_shardings(state_specs(spec, hyper),
                                                    mesh))}
    del params
    bsh = shard_batch_specs({k: (tuple(v.shape), v.dtype)
                             for k, v in batch.items()}, mesh)
    dbatch = {k: distribute(v, bsh[k]) for k, v in batch.items()}
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kops)
    got, walls, coll = [], [], None
    for i in range(steps):
        recorder = (collective_recorder() if record and i == steps - 1
                    else contextlib.nullcontext())
        sync()
        t0 = time.perf_counter()
        with recorder, use_mesh(mesh):
            dstate, m = step(dstate, dbatch)
        got.append((float(full(m["loss"])), float(full(m["grad_norm"]))))
        walls.append(time.perf_counter() - t0)
        if recorder is not None and hasattr(recorder, "records"):
            coll = recorder.records
    rec["launches"] = read_counts(kops)
    rec["flash_by_design"] = dict(kops.flash_attention.by_design)
    rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    rec["layouts"] = sorted({str(tuple(x.placements)) for x in
                             tree_leaves_of(dstate["params"])})
    rec.update(losses=[g[0] for g in got], ref_losses=[r[0] for r in ref],
               grad_norms=[g[1] for g in got],
               ref_grad_norms=[r[1] for r in ref], step_walls_s=walls)
    if coll is not None:
        from repro_torch.launch.roofline import collective_bytes
        rec["collectives_last_step"] = collective_bytes(coll)
    one = math.prod(mesh_shape) == 1
    tol_l, tol_n = ((0.0, 0.0) if one else
                    (DIST_LOSS_TOL_RANKS, DIST_NORM_TOL_RANKS))
    rec.update(loss_tol=tol_l, grad_norm_tol=tol_n, loss_rel_err=max(
        rel_err(g[0], r[0]) for g, r in zip(got, ref)),
        grad_norm_rel_err=max(rel_err(g[1], r[1]) for g, r in zip(got, ref)))
    for (gl, gn), (rl, rn) in zip(got, ref):
        check(math.isfinite(gl) and rel_err(gl, rl) <= tol_l,
              f"{arch} sharded loss {gl} vs unsharded {rl} (tol {tol_l})")
        check(rel_err(gn, rn) <= tol_n,
              f"{arch} sharded grad norm {gn} vs unsharded {rn} "
              f"(tol {tol_n})")
    per = cfg.n_layers * steps
    fa = kops.flash_attention
    check(fa.launches == 2 * per, f"{arch}: {fa.launches} flash forward "
          f"launches in the sharded run, want {2 * per} (a forward and a "
          f"remat recompute per layer and step)")
    for k in ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq"):
        check(rec["launches"][k] == per,
              f"{arch}: {k} {rec['launches'][k]} launches, want {per}")
    del dstate, dbatch, batch
    torch.cuda.empty_cache()
    return rec


def tree_leaves_of(tree) -> list:
    from repro_torch.train.tree import tree_leaves
    return tree_leaves(tree)


def dist_moe(kops, mesh_shape: tuple, seed: int) -> dict:
    """grok-1's MoE block at its published widths (d 6,144, 8 experts of
    d_ff 32,768, top-2; seeded bf16 weights, f32 router) on a 4,096-token
    prefill (B 2 x S 2,048) through apply_moe_sharded on a ("data",
    "model") mesh, against two references on the whole weights: the
    unsharded apply_moe on each data shard's tokens (the capacity of its
    t_loc tokens), and the JAX package's semantics, each (data shard,
    model peer)'s _moe_local summed over the peers."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import _mesh
    from repro_torch.models.layers import init_param
    from repro_torch.models.moe import _moe_local, apply_moe, \
        apply_moe_sharded, capacity, moe_spec
    from repro_torch.sharding import distribute_tree, tree_shardings, \
        use_mesh
    from repro_torch.sharding.rules import NamedSharding, distribute
    cfg = get_config("grok-1-314b")
    gen = torch.Generator(device=DEV).manual_seed(seed + 11)
    p = {k: init_param(sp, gen, torch.bfloat16 if sp.matrix
                       else torch.float32, DEV)
         for k, sp in moe_spec(cfg).items()}
    b, s = 2, MOE_TOKENS // 2
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=DEV).to(
        torch.bfloat16)
    dp, n_model = mesh_shape
    e = cfg.n_experts
    ep = e % n_model == 0
    e_local = e // n_model if ep else e
    cap = capacity((b // dp) * s, cfg)
    f_loc = cfg.d_ff_expert // n_model
    with torch.no_grad():
        parts = []
        for i in range(dp):
            xf = x[i * b // dp:(i + 1) * b // dp].reshape(-1, cfg.d_model)
            y = 0
            for r in range(n_model):
                if ep:
                    sl = slice(r * e_local, (r + 1) * e_local)
                    w = {k: p[k][sl] for k in ("wi", "wg", "wo") if k in p}
                else:
                    sl = slice(r * f_loc, (r + 1) * f_loc)
                    w = {k: p[k][..., sl] for k in ("wi", "wg") if k in p}
                    w["wo"] = p["wo"][:, sl]
                y = y + _moe_local(xf, p["router"], w["wi"], w.get("wg"),
                                   w["wo"], cfg, e_lo=r * e_local if ep
                                   else 0, e_local=e_local, cap=cap)[0]
            parts.append(y.reshape(b // dp, s, -1))
        want = torch.cat(parts)
        shards = [apply_moe(p, x[i * b // dp:(i + 1) * b // dp], cfg)
                  for i in range(dp)]
        plain = torch.cat([y for y, _ in shards])
        plain_aux = sum(float(a) for _, a in shards) / dp
    mesh = _mesh("cuda", mesh_shape, ("data", "model"))
    dpar = distribute_tree(p, tree_shardings(moe_spec(cfg), mesh))
    xd = distribute(x, NamedSharding(mesh, ("data", None, None)))
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    with use_mesh(mesh), torch.no_grad():
        y, aux = apply_moe_sharded(dpar, xd, cfg)
        y = full(y)
    sync()
    rec = {"arch": cfg.name, "mesh": list(mesh_shape),
           "mode": "ep" if ep else "tp", "experts_per_peer": e_local,
           "tokens": b * s, "capacity": cap, "wall_s":
           time.perf_counter() - t0,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "expert_weight_bytes_per_rank": sum(
               t.to_local().numel() * t.element_size()
               for k, t in dpar.items() if k != "router")}
    aux = float(full(aux))
    tol = 0.0 if math.prod(mesh_shape) == 1 else MOE_AUX_TOL_RANKS
    err = float((y.float() - want.float()).abs().max())
    err_plain = float((y.float() - plain.float()).abs().max())
    scale = float(want.float().abs().max())
    rec.update(max_abs_err=err, max_abs_err_apply_moe=err_plain,
               max_abs=scale, aux=aux, aux_apply_moe=plain_aux, aux_tol=tol)
    check(scale > 0 and err == 0,
          f"sharded MoE differs from _moe_local summed: {err} of {scale}")
    check(err_plain == 0 and rel_err(aux, plain_aux) <= tol,
          f"sharded MoE differs from apply_moe: {err_plain} of {scale}, "
          f"aux {aux} vs {plain_aux} (tol {tol})")
    del p, dpar, x, xd, y, want, plain, shards
    torch.cuda.empty_cache()
    return rec


def dist_podwise(mesh_shape: tuple, seed: int) -> dict:
    """compress_grads then podwise_mean on a ("pod", "data") mesh: each
    pod's seeded gradient, against the mean of every pod's dequantized
    gradient and within the JAX test's int8 bound of the true mean."""
    from repro_torch.launch.mesh import _mesh
    from repro_torch.train import grad_compress as gc
    mesh = _mesh("cuda", mesh_shape, ("pod", "data"))
    n_pod = mesh_shape[0]
    gen = torch.Generator(device=DEV).manual_seed(seed + 13)
    g = torch.randn((n_pod, 1 << 20), generator=gen, device=DEV)
    mine = g[mesh.get_local_rank("pod")]
    deq, _ = gc.compress_grads({"w": mine}, {"w": torch.zeros_like(mine)})
    got = gc.podwise_mean(deq, mesh)["w"]
    want = torch.stack([gc.compress_grads(
        {"w": g[i]}, {"w": torch.zeros_like(g[i])})[0]["w"]
        for i in range(n_pod)]).mean(0)
    err = float((got - want).abs().max())
    bound = float((got - g.mean(0)).abs().max())
    scale = float(g.abs().max()) / 127
    check(err <= 1e-6 and bound < 2.1 * scale,
          f"podwise_mean: {err} from the dequantized mean, {bound} from "
          f"the true mean (int8 bound {2.1 * scale})")
    return {"mesh": list(mesh_shape), "elements": g.shape[1],
            "max_abs_err": err, "err_to_true_mean": bound,
            "int8_bound": 2.1 * scale}


def dist_elastic(kops, mesh_shape: tuple, to: int, seed: int,
                 root: str) -> dict:
    """llama3.2-1b cut to CKPT_DIMS, sharded on a ("data", "model") mesh,
    saved through CheckpointManager (rank 0 writes host rows; the store's
    kernels on the card) and restored by remesh onto the first ``to``
    ranks: every leaf equal bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.ft.checkpoint import CheckpointManager
    from repro_torch.ft.elastic import remesh, restore_elastic
    from repro_torch.launch.mesh import _mesh
    from repro_torch.models.model import init_params, model_spec
    from repro_torch.sharding import distribute_tree, tree_shardings
    cfg = dataclasses.replace(get_config(ARCH), **CKPT_DIMS)
    spec = model_spec(cfg)
    params = init_params(cfg, seed, DEV)
    mesh = _mesh("cuda", mesh_shape, ("data", "model"))
    dparams = distribute_tree(params, tree_shardings(spec, mesh))
    reset_counts(kops)
    ckpt = CheckpointManager(os.path.join(root, "ckpt"), async_save=False)
    t0 = time.perf_counter()
    ckpt.save(1, dparams)
    t_save = time.perf_counter() - t0
    mesh2 = remesh(devices=list(range(to)))
    t0 = time.perf_counter()
    got = restore_elastic(ckpt, 1, like=params, spec_tree=spec, mesh=mesh2)
    t_restore = time.perf_counter() - t0
    rec = {"dims": CKPT_DIMS, "params": cfg.param_count(),
           "from_mesh": list(mesh_shape), "to_mesh": list(mesh2.shape),
           "save_s": t_save, "restore_s": t_restore,
           "launches": {k: v for k, v in read_counts(kops).items() if v}}
    if mesh2.get_coordinate() is not None:
        same = all(torch.equal(full(a), b) for a, b in
                   zip(tree_leaves_of(got), tree_leaves_of(params)))
        check(same, "elastic restore is not bit for bit")
        rec["bitwise"] = same
    return rec


def dist_rank(root: str, rank: int, world: int, seed: int) -> None:
    """One rank of the distributed phase: joins the NCCL group through a
    FileStore in ``root``, runs every check on its card (the kernels
    load from the build the parent made) and writes its record to
    ``root/rank<rank>.json``."""
    import torch.distributed as dist
    from repro_torch.kernels import ops as kops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(root, "store"), world), rank=rank, world_size=world,
        device_id=dev)
    _, shapes = dist_layout(torch.cuda.device_count())
    t0 = time.perf_counter()
    rec = {"rank": rank, "device": str(dev),
           "llama": dist_steps(kops, ARCH, shapes["llama"], DIST_STEPS,
                               seed, record=True)}
    rec["qwen"] = dist_steps(kops, "qwen2-0.5b", shapes["qwen"],
                             DIST_QWEN_STEPS, seed)
    rec["moe"] = dist_moe(kops, shapes["moe"], seed)
    rec["podwise"] = dist_podwise(shapes["pod"], seed)
    rec["elastic"] = dist_elastic(kops, shapes["llama"],
                                  shapes["elastic_to"], seed, root)
    rec["seconds"] = time.perf_counter() - t0
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def phase_distributed(root: str, seed: int) -> dict:
    """The distributed phase: its ranks (dist_layout) each in a process of
    its own on a card of its own, every check in dist_rank; rank 0's
    record, with each rank's wall and peak memory."""
    n_cards = torch.cuda.device_count()
    world, shapes = dist_layout(n_cards)
    code = (f"import sys; sys.path[:0] = [{os.path.join(HERE, 'src')!r}, "
            f"{HERE!r}]; import chip_smoke; chip_smoke.dist_rank("
            f"{root!r}, {{r}}, {world}, {seed})")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", code.format(r=r)],
                              cwd=HERE, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DIST_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    check(codes == [0] * world, "distributed ranks failed: " + "\n".join(
        f"--- rank {r} (exit {c})\n{log[-3000:]}"
        for r, (c, log) in enumerate(zip(codes, logs))))
    ranks = []
    for r in range(world):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    rec = {"phase": "distributed", "backend": "nccl", "ranks": world,
           "cards": n_cards, "ranks_per_card": 1, "meshes": shapes,
           "wall_s": time.perf_counter() - t0,
           "rank_seconds": [r["seconds"] for r in ranks],
           "peak_memory_bytes_by_rank": {
               k: [r[k]["peak_memory_bytes"] for r in ranks]
               for k in ("llama", "qwen", "moe")},
           **{k: ranks[0][k] for k in ("llama", "qwen", "moe", "podwise",
                                       "elastic")}}
    emit(rec)
    launches = {k: rec["llama"]["launches"][k] + rec["qwen"]["launches"][k]
                for k in PATH_KERNELS["train"]}
    return {"launches": launches}


def kernel_row(name: str, m: dict, launches: int) -> dict:
    """One row of the kernels line from the kernel's record ``m``."""
    source, replaces = SOURCES[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": m["max_abs_diff"], "ms": m["kernel_ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "shape": m["shape"],
            **{k: m[k] for k in ("bound_both_operands_ms", "rounds_won",
                                 "device_ms", "null_lse_ms", "lse_ms",
                                 "null_lse_rounds_ms", "lse_rounds_ms",
                                 "bound_ex2_sfu_ms", "bound_fp32_ms",
                                 "bound_bytes_ms", "f64")
               if k in m}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of every generated release and input")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 2
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke.py: no src/repro_torch beside {HERE}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch import core
    from repro_torch.core import FieldSchema, VersionedStore, placement
    from repro_torch.kernels import _build, _compat, launch, ops as kops
    from repro_torch.launch import roofline

    # f32 products in full f32 on the card (the plain versions and the
    # serving checks compare against f32 arithmetic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    # the tile winner cache of this run, in the build tree (never ~): empty
    # until the tiles phase, the last, sweeps
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    tiles_root = tempfile.mkdtemp(prefix="chip_smoke_tiles_",
                                  dir=os.path.join(HERE, "build"))
    atexit.register(shutil.rmtree, tiles_root, True)
    os.environ[launch.CACHE_ENV] = os.path.join(tiles_root,
                                                "tiles_torch.json")
    launch.reset_cache()
    smi = nvidia_smi_line()
    phase_env(_build.build_all(), smi)
    rng = np.random.default_rng(args.seed)
    bench = KernelBench(kops, roofline, smi, TIMED_REPS)
    phase_kernel_edges(bench, rng)
    phase_kernel_edges_sharding(bench, rng)
    phase_kernel_edges_serving(bench, rng)
    phase_kernel_edges_merge(bench, rng)
    releases = make_releases(N_ENTRIES, len(RELEASE_TS), args.seed)
    main_out = phase_main_path(VersionedStore, FieldSchema, kops, releases)
    merge_out = phase_merge(kops, releases)
    phase_kernel_main(bench, kops, _compat, releases, main_out)
    # store directories live inside the checkout's gitignored build tree
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(HERE,
                                                                  "build"))
    try:
        shard_out = phase_sharding(core, placement, kops, releases, root)
        phase_kernel_sharding(bench, shard_out)
        phase_sharding_parity(core, args.seed, root)
        pers_out = phase_persistence(VersionedStore, FieldSchema, kops,
                                     releases, root)
        phase_codec_main(bench, _compat, pers_out.pop("codec_in"), rng)
        phase_persistence_parity(VersionedStore, FieldSchema, args.seed,
                                 root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    phase_parity(VersionedStore, FieldSchema, args.seed)
    # the serving tier over stores of the same releases; spills in the
    # build tree
    root = tempfile.mkdtemp(prefix="chip_smoke_frontdoor_",
                            dir=os.path.join(HERE, "build"))
    try:
        frontdoor_out = phase_frontdoor(core, kops, releases, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del releases
    # the facade's releases, stores and cache, in the build tree too
    root = tempfile.mkdtemp(prefix="chip_smoke_gestore_",
                            dir=os.path.join(HERE, "build"))
    try:
        gestore_out = phase_gestore(core, kops, args.seed, root)
        phase_kernel_gestore(bench, kops, gestore_out)
        phase_gestore_parity(core, args.seed, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    serving_out = phase_serving(kops, args.seed)
    phase_kernel_serving(bench, merge_out, serving_out)
    phase_serving_parity(args.seed)
    phase_kernel_edges_scans(bench, args.seed)
    families_out = phase_families(kops, args.seed)
    phase_kernel_families(bench, families_out, args.seed)
    phase_kernel_scans(bench, families_out)
    phase_kernel_edges_whisper(bench, args.seed)
    whisper_out = phase_whisper(kops, args.seed)
    phase_kernel_whisper(bench, whisper_out, args.seed)
    search_out = phase_search(core, kops, args.seed)
    phase_kernel_search(bench, search_out, args.seed)
    # training: the backward's edges, the train path, chunked against xla
    # and delta checkpoints (their store directory in the build tree)
    phase_kernel_edges_train(bench, rng)
    root = tempfile.mkdtemp(prefix="chip_smoke_train_",
                            dir=os.path.join(HERE, "build"))
    try:
        train_out = phase_train(kops, args.seed, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    phase_kernel_train(bench, train_out, args.seed)
    ft_out = phase_families_train(kops, args.seed)
    phase_kernel_families_train(bench, ft_out, args.seed)
    # the distributed phase's ranks, their store files in the build tree
    root = tempfile.mkdtemp(prefix="chip_smoke_dist_",
                            dir=os.path.join(HERE, "build"))
    try:
        dist_out = phase_distributed(root, args.seed)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    phase_tiles(bench, kops, args.seed)
    # each kernel's launches come from the path that runs it: flash at
    # whisper's shapes from whisper, the codec from persistence, the route
    # and the stacked scan from sharding, the merge from its phase, flash
    # attention from serving (at the encoder's shape, from search; at the
    # train shape, from train; at the families' shapes and in f32 at D 16,
    # from families), the fingerprint at UniProt's widths from gestore, the
    # flash backward from train (its f32 rows from the f32
    # chunked-against-xla check, its D 128 rows from no path; at D 112 and
    # at D 16 from families_train, at D 32 from no path), the rest from the
    # main path (chain
    # decode's rows: the launches of their gathers); the frontdoor
    # phase's launches are on its own line
    path_of = {k: (whisper_out if "whisper" in k
                   else pers_out if k.startswith("delta_")
                   else ft_out if k in ft_out["launches"]
                   else train_out if k.startswith("flash_bwd")
                   or k == "flash_attention_train"
                   else gestore_out if k.startswith("fingerprint_w")
                   else shard_out if k in ("shard_route", "shard_route_bytes",
                                           "stacked_masked_cumsum")
                   else merge_out if k == "masked_merge"
                   else families_out if k in families_out["launches"]
                   else search_out if k.startswith("flash_attention_d")
                   else serving_out if k.startswith("flash_attention")
                   else main_out) for k in SOURCES}
    rows = [kernel_row(name, bench.main[name],
                       path_of[name]["launches"][name]) for name in SOURCES]
    emit({"kernels": rows, "frontdoor_launches": frontdoor_out["launches"],
          "train_checkpoint_launches": train_out["checkpoint"]["launches"],
          "distributed_launches": dist_out["launches"],
          "seconds": time.perf_counter() - t_start,
          "phase_ends_s": PHASE_ENDS})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
