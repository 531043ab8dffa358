"""The error every kernel wrapper raises, in a module without torch so
that the host modules (the build, the native library's loader, the
mapping pipeline, the fill service's client) can name it in processes
that never import torch.  ``device.py`` re-exports it: there is one
class, whichever module it is imported from."""


class DeviceKernelError(RuntimeError):
    """A kernel of this package failed to build, to launch or to run, or a
    device call around it failed.  Never caught by the mapping pipeline:
    a device fault stops the run instead of degrading to the host path."""
