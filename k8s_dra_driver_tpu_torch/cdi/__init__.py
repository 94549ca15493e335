"""Per-claim transient CDI spec files for GPU claims."""
