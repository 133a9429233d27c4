"""Alias entry point of the reference's ``gan_inference_svhn.py``:
``runs/gan_inference.py`` with ``--dataset svhn`` (SVHN 32x32)::

    python -m graphical_gan_tpu_torch.runs.gan_inference_svhn
"""
from graphical_gan_tpu_torch.runs.gan_inference import main as _main


def main(argv=None):
    _main(["--dataset", "svhn"] + (argv or __import__("sys").argv[1:]))


if __name__ == "__main__":
    main()
