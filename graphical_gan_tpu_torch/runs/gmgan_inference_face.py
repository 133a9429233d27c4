"""Alias entry point of the reference's ``gmgan_inference_face.py``:
``runs/gmgan.py`` with ``--dataset celeba`` (CelebA 64x64)::

    python -m graphical_gan_tpu_torch.runs.gmgan_inference_face
"""
from graphical_gan_tpu_torch.runs.gmgan import main as _main


def main(argv=None):
    _main(["--dataset", "celeba"] + (argv or __import__("sys").argv[1:]))


if __name__ == "__main__":
    main()
