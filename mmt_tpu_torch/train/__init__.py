"""Training side of the port: step, losses, optimizers, metrics,
checkpoints and the trainer; ``python -m mmt_tpu_torch.train`` runs the
CLI (cli.py)."""
