"""Orbax checkpoint directories without JAX, orbax or tensorstore.

The JAX package saves its native checkpoint through
``orbax.checkpoint.PyTreeCheckpointer``: zarr v2 arrays in an OCDBT store,
their chunks compressed with zstd.  This subpackage reads that layout with
readers of its own (``zstd``, ``crc32c``, ``ocdbt``, ``zarr``) and writes the
plain layout orbax also restores (``tree.write_pytree``).  It imports numpy
and nothing else outside the standard library.
"""
