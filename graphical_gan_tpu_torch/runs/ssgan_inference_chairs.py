"""Alias entry point of the reference's ``ssgan_inference_chairs.py``:
``runs/ssgan.py`` with ``--dataset chairs`` (3D chairs, 31 frames of 64x64x3)::

    python -m graphical_gan_tpu_torch.runs.ssgan_inference_chairs
"""
from graphical_gan_tpu_torch.runs.ssgan import main as _main


def main(argv=None):
    _main(["--dataset", "chairs"] + (argv or __import__("sys").argv[1:]))


if __name__ == "__main__":
    main()
