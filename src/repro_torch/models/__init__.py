"""The language-model stack of the kNN-LM serving path (port of
``repro.models``): layers, rotary embeddings, attention and the layer
stack. Parameters are plain dicts of tensors with the reference's keys,
stacked layers on a leading layer axis."""
