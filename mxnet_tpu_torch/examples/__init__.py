"""Command-line programs of mxnet_tpu_torch: ``train_imagenet``, the
north-star training CLI (``python3 -m mxnet_tpu_torch.examples.
train_imagenet``), and its ``common`` data and fit plumbing."""
