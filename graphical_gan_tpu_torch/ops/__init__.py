"""Tensor ops of the port, over NHWC tensors and ``{name: tensor}`` params."""

from graphical_gan_tpu_torch.ops.activations import (  # noqa: F401
    LEAKY_ALPHA, activation, dropout, gaussian_noise, leaky_relu, relu)
from graphical_gan_tpu_torch.ops.conv import (  # noqa: F401
    conv1d, conv2d, conv3d, deconv2d)
from graphical_gan_tpu_torch.ops.layout import (  # noqa: F401
    flatten_image, unflatten_image)
from graphical_gan_tpu_torch.ops.linear import linear  # noqa: F401
from graphical_gan_tpu_torch.ops.norm import (  # noqa: F401
    batchnorm, batchnorm_act, cond_batchnorm, layernorm)
from graphical_gan_tpu_torch.ops.special import (  # noqa: F401
    ladder, minibatch_layer)
