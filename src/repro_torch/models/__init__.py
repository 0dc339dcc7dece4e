"""Model code: the layer library, the decoder-only transformer LM and the
model dispatcher (ports of ``repro.models``)."""
