"""Utilities (counterpart of ``quantizations_tpu/utils``): device timing,
profiling and metrics, and the binding to the native golden quantizer."""
