"""LM serving with kNN-LM retrieval (port of ``repro.serving``): the
sampler, prefill and decode steps, the continuous batcher and the
retrieval path over a Pyramid datastore."""
