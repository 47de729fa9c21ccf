"""The port's process entry points, run as modules:

    python -m walkai_nos_tpu_torch.cmd.replay CAPTURE [options]
"""
