"""Partition placement math (``sharding``); meshes come with the multi-rank layout."""
