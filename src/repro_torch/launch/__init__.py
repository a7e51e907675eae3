"""repro_torch.launch — entry points. Ported so far: ``serve`` (one card,
no mesh)."""
