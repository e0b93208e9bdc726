"""The benchmark's fixed machinery: loading a cell by name, the traffic
generator, the closed-loop window, the trace reduction, the kernels'
operation and byte counts, the import check and the comparison that
decides ``correct``."""
