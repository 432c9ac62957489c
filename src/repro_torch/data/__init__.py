"""The synthetic LM data pipeline (``tokens.py``)."""
