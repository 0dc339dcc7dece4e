"""Model code: the layer library, the transformer LM (dense, MoE, VLM and
audio families) and the model dispatcher (ports of ``repro.models``)."""
