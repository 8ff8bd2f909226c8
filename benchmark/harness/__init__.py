"""The benchmark's harness: scenes, traffic drivers, the trace reader and
the check."""
