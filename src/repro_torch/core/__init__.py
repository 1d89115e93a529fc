"""Value types, layouts, the blocking model and the plain direct conv.

Modules are imported by path (``repro_torch.core.layout``, ...); this package
initializer stays empty so that importing one of them never pulls in the
others.
"""
