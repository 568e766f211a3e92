"""The spark layer of the PyTorch port: only the parquet row-group reader
so far (``store.py``)."""
