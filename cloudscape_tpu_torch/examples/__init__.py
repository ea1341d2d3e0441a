"""The demo and screenshot scripts of the PyTorch port (`python -m
cloudscape_tpu_torch.examples.demo`, `... .examples.screenshots`)."""
