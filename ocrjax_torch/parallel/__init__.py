"""Data and tensor parallelism on torch.distributed (mesh) and the
multi-process dry run (dryrun)."""
