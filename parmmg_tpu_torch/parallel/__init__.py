"""Partitioning, distribution and merging of stacked shards."""
