"""Core: ARMT associative memory and the diagonal-batching schedule and
executors."""
