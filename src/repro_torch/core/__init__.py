"""Packet format, resident bank, executor, forwarding pipeline, switching harnesses."""
