"""Alias entry point of the reference's ``gmgan_inference_cifar10.py``:
``runs/gmgan.py`` with ``--dataset cifar10`` (CIFAR-10 32x32)::

    python -m graphical_gan_tpu_torch.runs.gmgan_inference_cifar10
"""
from graphical_gan_tpu_torch.runs.gmgan import main as _main


def main(argv=None):
    _main(["--dataset", "cifar10"] + (argv or __import__("sys").argv[1:]))


if __name__ == "__main__":
    main()
