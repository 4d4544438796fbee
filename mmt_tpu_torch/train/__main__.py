"""``python -m mmt_tpu_torch.train``: the port's training CLI (cli.py)."""

from mmt_tpu_torch import cli

if __name__ == "__main__":
  cli.main()
