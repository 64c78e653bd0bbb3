"""Serving stack of the port: paged KV cache, engines, scheduler, traces."""
