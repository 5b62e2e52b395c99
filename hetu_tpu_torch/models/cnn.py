"""The CNN model zoo (twin of ``examples/cnn/models``): the helpers of
``common.py`` and ``mlp``, ``logreg``, ``cnn_3_layers``, ``lenet``,
``alexnet``, ``vgg`` (16, 19), ``resnet`` (18, 34).

Each builds the JAX package's graph op for op, with the same variable
names, so weights carry across by name (``Executor.load_dict``).  Every
model returns ``(loss, softmax(logits))`` for a one-hot ``y_``.  The
BatchNorms take no name, so their running statistics are
``bn_running_mean``, ``bn_running_mean~1``, ... in topological order, in
both packages.
"""
from .. import initializers as init
from .. import ops


def conv2d(x, in_ch, out_ch, kernel_size=3, stride=1, padding=1, name="conv",
           data_format="NCHW"):
    w = init.he_normal(shape=(out_ch, in_ch, kernel_size, kernel_size),
                       name=name + "_weight")
    return ops.conv2d_op(x, w, stride=stride, padding=padding,
                         data_format=data_format)


def bn(x, ch, name, relu=False, data_format="NCHW"):
    scale = init.ones(shape=(ch,), name=name + "_scale")
    bias = init.zeros(shape=(ch,), name=name + "_bias")
    x = ops.batch_normalization_op(x, scale, bias, momentum=0.9, eps=1e-5,
                                   data_format=data_format)
    return ops.relu_op(x) if relu else x


def fc(x, shape, name, relu=False):
    w = init.he_normal(shape=shape, name=name + "_weight")
    b = init.zeros(shape=shape[-1:], name=name + "_bias")
    x = ops.linear_op(x, w, b)
    return ops.relu_op(x) if relu else x


def ce_loss(logits, y_):
    loss = ops.softmaxcrossentropy_op(logits, y_)
    return ops.reduce_mean_op(loss, [0]), ops.softmax_op(logits)


def mlp(x, y_, num_class=10, hidden=256):
    """3-layer MLP on (N, 784) inputs."""
    x = fc(x, (784, hidden), "mlp_fc1", relu=True)
    x = fc(x, (hidden, hidden), "mlp_fc2", relu=True)
    logits = fc(x, (hidden, num_class), "mlp_fc3")
    return ce_loss(logits, y_)


def logreg(x, y_, num_class=10):
    """Logistic regression on (N, 784) inputs."""
    return ce_loss(fc(x, (784, num_class), "logreg"), y_)


def cnn_3_layers(x, y_, num_class=10):
    """3-conv CNN on 28x28 inputs."""
    x = ops.array_reshape_op(x, output_shape=(-1, 1, 28, 28))
    x = ops.relu_op(conv2d(x, 1, 32, 5, 1, 2, "c1"))
    x = ops.relu_op(conv2d(x, 32, 64, 5, 2, 2, "c2"))
    x = ops.relu_op(conv2d(x, 64, 64, 5, 2, 2, "c3"))
    x = ops.array_reshape_op(x, output_shape=(-1, 7 * 7 * 64))
    return ce_loss(fc(x, (7 * 7 * 64, num_class), "fc"), y_)


def lenet(x, y_, num_class=10):
    """LeNet-5 on 28x28 inputs."""
    x = ops.array_reshape_op(x, output_shape=(-1, 1, 28, 28))
    x = ops.relu_op(conv2d(x, 1, 6, 5, 1, 2, "l1"))
    x = ops.max_pool2d_op(x, 2, 2, 0, 2)
    x = ops.relu_op(conv2d(x, 6, 16, 5, 1, 0, "l2"))
    x = ops.max_pool2d_op(x, 2, 2, 0, 2)
    x = ops.array_reshape_op(x, output_shape=(-1, 16 * 5 * 5))
    x = fc(x, (16 * 5 * 5, 120), "f1", relu=True)
    x = fc(x, (120, 84), "f2", relu=True)
    return ce_loss(fc(x, (84, num_class), "f3"), y_)


def alexnet(x, y_, num_class=10):
    """CIFAR-scale AlexNet (dropout 0.5 on the two hidden layers)."""
    x = bn(conv2d(x, 3, 64, 5, 1, 2, "a1"), 64, "a1bn", relu=True)
    x = ops.max_pool2d_op(x, 2, 2, 0, 2)
    x = bn(conv2d(x, 64, 192, 3, 1, 1, "a2"), 192, "a2bn", relu=True)
    x = ops.max_pool2d_op(x, 2, 2, 0, 2)
    x = ops.relu_op(conv2d(x, 192, 384, 3, 1, 1, "a3"))
    x = ops.relu_op(conv2d(x, 384, 256, 3, 1, 1, "a4"))
    x = ops.relu_op(conv2d(x, 256, 256, 3, 1, 1, "a5"))
    x = ops.max_pool2d_op(x, 2, 2, 0, 2)
    x = ops.array_reshape_op(x, output_shape=(-1, 256 * 4 * 4))
    x = ops.dropout_op(fc(x, (256 * 4 * 4, 1024), "f1", relu=True), 0.5)
    x = ops.dropout_op(fc(x, (1024, 512), "f2", relu=True), 0.5)
    return ce_loss(fc(x, (512, num_class), "f3"), y_)


_VGG = {16: (2, 2, 3, 3, 3), 19: (2, 2, 4, 4, 4)}


def vgg(x, y_, num_layers, num_class=10):
    """VGG-16/19 with BatchNorm and a CIFAR head."""
    in_ch = 3
    for b, (rep, ch) in enumerate(zip(_VGG[num_layers],
                                      (64, 128, 256, 512, 512))):
        for r in range(rep):
            x = bn(conv2d(x, in_ch, ch, 3, 1, 1, f"v{b}_{r}"), ch,
                   f"v{b}_{r}bn", relu=True)
            in_ch = ch
        x = ops.max_pool2d_op(x, 2, 2, 0, 2)
    x = ops.array_reshape_op(x, output_shape=(-1, 512))
    x = fc(x, (512, 4096), "f1", relu=True)
    x = fc(x, (4096, 4096), "f2", relu=True)
    return ce_loss(fc(x, (4096, num_class), "f3"), y_)


def vgg16(x, y_, num_class=10):
    return vgg(x, y_, 16, num_class)


def vgg19(x, y_, num_class=10):
    return vgg(x, y_, 19, num_class)


def _basic_block(x, in_ch, out_ch, stride, name, df):
    shortcut = x
    x = bn(conv2d(x, in_ch, out_ch, 3, stride, 1, name + "_c1",
                  data_format=df), out_ch, name + "_bn1", relu=True,
           data_format=df)
    x = bn(conv2d(x, out_ch, out_ch, 3, 1, 1, name + "_c2",
                  data_format=df), out_ch, name + "_bn2", data_format=df)
    if in_ch != out_ch or stride > 1:
        shortcut = bn(conv2d(shortcut, in_ch, out_ch, 1, stride, 0,
                             name + "_cs", data_format=df), out_ch,
                      name + "_bns", data_format=df)
    return ops.relu_op(x + shortcut)


_RESNET = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}


def resnet(x, y_, num_layers=18, num_class=10, data_format="NCHW"):
    """ResNet-18/34 with the CIFAR stem (a 3x3 convolution, no max pool)
    on an NCHW feed; ``data_format="NHWC"`` transposes once at the stem
    and keeps the activations channels-last to the head."""
    df = data_format
    if df == "NHWC":
        x = ops.transpose_op(x, perm=(0, 2, 3, 1))
    x = bn(conv2d(x, 3, 64, 3, 1, 1, "stem", data_format=df), 64,
           "stem_bn", relu=True, data_format=df)
    in_ch = 64
    for stage, (rep, ch) in enumerate(zip(_RESNET[num_layers],
                                          (64, 128, 256, 512))):
        for r in range(rep):
            stride = 2 if (stage > 0 and r == 0) else 1
            x = _basic_block(x, in_ch, ch, stride, f"s{stage}b{r}", df)
            in_ch = ch
    x = ops.avg_pool2d_op(x, 4, 4, 0, 4, data_format=df)
    x = ops.array_reshape_op(x, output_shape=(-1, 512))
    return ce_loss(fc(x, (512, num_class), "head"), y_)


def resnet18(x, y_, num_class=10, data_format="NCHW"):
    return resnet(x, y_, 18, num_class, data_format)


def resnet34(x, y_, num_class=10, data_format="NCHW"):
    return resnet(x, y_, 34, num_class, data_format)
