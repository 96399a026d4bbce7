"""The scoring engine behind serving."""
