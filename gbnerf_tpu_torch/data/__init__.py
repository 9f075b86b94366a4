"""Scene loaders and ray banks (numpy on the host, torch on the device).

Import the submodules directly; this package imports nothing at load.
"""
