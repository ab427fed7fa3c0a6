"""Post-hoc analytics over finished run folders."""
