"""repro_torch.train — step factories. Ported so far: the serving steps
(``make_prefill``, ``make_serve_step``); the training step, optimizer and
gradient compression wait for the training slice (ROADMAP.md)."""
