"""Seeded synthetic analogues of the paper's datasets."""
