"""Roofline constants of the port's card (``roofline``)."""
