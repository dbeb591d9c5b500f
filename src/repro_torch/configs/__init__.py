"""Serving configurations of the port (``khi_serve``)."""
