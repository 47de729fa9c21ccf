"""The port's demo server pod, run as a module:

    python -m walkai_nos_tpu_torch.app.main

(`app/main.py`: the torch counterpart of
`demos/tpu-sharing-comparison/app/main.py`.)
"""
