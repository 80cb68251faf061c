"""Entry points of the port: ``python -m repro_torch.launch.serve``,
``train``, ``dryrun``, ``profile_cell`` and ``report`` (the dry run's
``mesh``, ``op_costs`` and ``roofline`` beside them)."""
