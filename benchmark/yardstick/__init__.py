"""The benchmark's own pieces: input generators, the plain zarr v2 store
format, FLOP and byte counts, peaks, the profiler reduction and the cell
modules.  Frozen copies of port code name the file and commit they were
copied from; the port may change after that, this copy does not.
"""
