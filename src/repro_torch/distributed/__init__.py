"""Elastic resharding of the sharded index (``elastic.py``)."""
