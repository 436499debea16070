"""``python -m paddle_tpu_torch.distributed.launch``: one process per
rank on one node (``main.py``)."""
