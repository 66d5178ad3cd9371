"""Decode attention over a paged K/V pool: `paged_attention`."""
