"""VITS model in PyTorch (counterpart of ``mimic3_tpu.models.vits``)."""
