"""The pod distribution layer (port of ``repro.dist``): the error-feedback
ISP exchange across a leading pod dimension (``compression``) and the
pool-size transitions of the scale-in auto-tuner (``elastic``). The
modules are imported on first use.
"""

from repro_torch._exports import lazy

__all__ = ["compression", "elastic"]
__getattr__ = lazy(__name__, {
    "compression": ("repro_torch.dist.compression", None),
    "elastic": ("repro_torch.dist.elastic", None),
})
