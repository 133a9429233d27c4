"""Alias entry point of the reference's ``ssgan_inference_moving_mnist.py``:
``runs/ssgan.py`` with ``--dataset moving_mnist`` (moving-MNIST, 16 frames of 64x64)::

    python -m graphical_gan_tpu_torch.runs.ssgan_inference_moving_mnist
"""
from graphical_gan_tpu_torch.runs.ssgan import main as _main


def main(argv=None):
    _main(["--dataset", "moving_mnist"] + (argv or __import__("sys").argv[1:]))


if __name__ == "__main__":
    main()
