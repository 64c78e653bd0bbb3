"""Fault and straggler detection of the port (the framework-neutral parts)."""
