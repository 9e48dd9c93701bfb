"""Data: the USPS and MNIST loaders, the in-memory dataset, the target-view transforms and batching."""
