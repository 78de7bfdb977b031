"""Host data layer of the port (own copies of drn_tpu/data/): vocab,
feature readers, the dataset loaders, staging, validation and batching."""
