"""Test support: named crash points (`faults`)."""
