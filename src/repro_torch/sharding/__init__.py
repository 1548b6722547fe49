"""Partition rules and layouts of the train state, batches and caches."""
