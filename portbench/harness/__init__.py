"""The benchmark's general code: nothing here names a configuration, a
traffic mix, a cell or a per-layer metric; those are files found by name
(:mod:`portbench.harness.registry`)."""
