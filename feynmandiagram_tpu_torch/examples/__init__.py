"""Examples of the port, each runnable as
``python -m feynmandiagram_tpu_torch.examples.<name>``."""
