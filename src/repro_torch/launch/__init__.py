"""Launchers of the port (``python -m repro_torch.launch.<name>``); the
counterpart of ``repro.launch``, of which only ``serve`` is ported."""
