"""Launchers (port of ``repro.launch``, which exports no names): the
train and serve entry points, the host-environment tuning and the
decode probe."""
