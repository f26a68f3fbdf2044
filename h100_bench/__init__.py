"""The H100 benchmark of ``abnet3_torch`` (see README.md)."""
