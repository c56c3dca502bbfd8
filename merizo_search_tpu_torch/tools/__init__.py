"""Measurement tools of the port, each runnable as `python -m merizo_search_tpu_torch.tools.<name>`."""
