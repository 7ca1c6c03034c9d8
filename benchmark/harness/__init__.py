"""The benchmark's harness: cell definitions found by name, the seeded
inputs, the plain reference, the counts, the drive of one run, the trace
and the check."""
