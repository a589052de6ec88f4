"""The training data path (data/ in the JAX package): the dataset, its
decoded cache and the input pipelines."""
