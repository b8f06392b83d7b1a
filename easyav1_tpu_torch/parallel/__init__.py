"""Multi-stream batches on one card: the counterpart of
`easyav1_tpu/parallel/`."""
