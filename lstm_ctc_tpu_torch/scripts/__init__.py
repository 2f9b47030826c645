"""Measuring tools of the port (``python -m lstm_ctc_tpu_torch.scripts.<tool>``)."""
