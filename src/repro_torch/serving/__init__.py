"""Serving (port of ``repro.serving``): Pyramid's serving engine
(coordinator, executors, Monitor, hedging, failure recovery), its fault
schedules and autoscaler, and LM serving with kNN-LM retrieval (the
sampler, prefill and decode steps, the continuous batcher and the
retrieval path over a Pyramid datastore)."""
