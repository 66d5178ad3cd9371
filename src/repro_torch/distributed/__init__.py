"""Sharding rules, parameter specs and their DTensor placements."""
