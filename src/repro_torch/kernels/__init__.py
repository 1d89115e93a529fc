"""Kernel wrappers, their plain PyTorch versions and the CUDA build.

Modules are imported by path; this initializer stays empty so that the CPU
tests can import any of them without a CUDA toolchain.
"""
