"""Offline brick builder (host numpy, and the native core)."""
