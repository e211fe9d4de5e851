"""The benchmark's arithmetic, frozen: the card's peaks, a model's forward
operations, the int8 conv's roofline bound, the device-time categories and
the exact scan's bytes.  Copies of the program's own accounting
(``pps_tpu_torch/utils/flops.py``, ``chip_smoke.py:int8_bound``,
``pps_tpu_torch/tools/trace_top_ops.py:category``), kept here so that an
edit of the program cannot move the yardstick; ``tests/
test_portbench_yardstick.py`` holds each copy against its origin.
"""

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
PEAKS = {
    'bfloat16': 989e12,   # bf16 tensor-core FLOP/s
    'int8': 1979e12,      # int8 tensor-core OP/s
}
HBM_BYTES_PER_S = 3.35e12

BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def body_convs(sizes):
    """The body's convs at the configuration's input size, in order, as
    (name, c_in, h, w, c_out, k, stride, groups) with each conv's input
    size (stride on the first 1x1, as the published R-50)."""
    w, h = sizes['scale']
    out = [('conv1', 3, h, w, 64, 7, 2, 1)]
    h, w = -(-h // 4), -(-w // 4)  # conv1 /2, then the 3x3/2 max pool
    dim_in = 64
    stages = zip(('res2', 'res3', 'res4', 'res5'), BLOCKS[sizes['depth']],
                 (256, 512, 1024, 2048), (64, 128, 256, 512),
                 (1, 2, 2, sizes['res5_stride']))
    for stage, n, dim_out, inner, stride in stages:
        for i in range(n):
            s = stride if i == 0 else 1
            p = '{}_{}'.format(stage, i)
            if i == 0 and dim_in != dim_out:
                out.append((p + '_branch1', dim_in, h, w, dim_out, 1, s, 1))
            out.append((p + '_branch2a', dim_in, h, w, inner, 1, s, 1))
            h, w = -(-h // s), -(-w // s)
            out.append((p + '_branch2b', inner, h, w, inner, 3, 1, 1))
            out.append((p + '_branch2c', inner, h, w, dim_out, 1, 1, 1))
            dim_in = dim_out
    return out


def conv_ops(conv):
    """Multiply-adds x 2 of one conv for one image."""
    _, cin, h, w, cout, k, s, groups = conv
    return 2 * (-(-h // s)) * (-(-w // s)) * k * k * (cin // groups) * cout


def model_fwd_flops(sizes):
    """Forward FLOPs per image: the body's convs, the stacked per-combo
    head (2048 -> D) and the classifiers (D -> NUM_CLASSES), as
    ``utils/flops.model_fwd_flops`` counts them (BN, pooling and
    elementwise work left out)."""
    total = sum(conv_ops(c) for c in body_convs(sizes))
    r = 2 ** sizes['strips'] - 1
    d = sizes['bpm_dim']
    return total + 2 * r * (2048 * d + d * sizes['num_classes'])


def int8_bound(conv, n, x_bytes, out_bytes):
    """(ops s, bytes s) of one int8 conv over a batch of ``n``: its
    products over the dense int8 peak, and its input (``x_bytes`` per
    element), int8 weights, scales and output over the memory rate."""
    _, cin, h, w, cout, k, s, groups = conv
    ho, wo = -(-h // s), -(-w // s)
    ops = 2.0 * n * ho * wo * k * k * (cin // groups) * cout
    nbytes = (n * h * w * cin * x_bytes + cout * k * k * cin // groups
              + 4 * (2 * cout + cin) + n * ho * wo * cout * out_bytes)
    return ops / PEAKS['int8'], nbytes / HBM_BYTES_PER_S


def int8_body_bound(sizes, n):
    """Seconds the int8 body's convs need at least for a batch of ``n``,
    and which bound sets it: the stem reads float32, the rest bfloat16,
    every output bfloat16."""
    ops = nbytes = 0.0
    for c in body_convs(sizes):
        o, b = int8_bound(c, n, 4 if c[1] == 3 else 2, 2)
        ops += o
        nbytes += b
    return max(ops, nbytes), ('bytes' if nbytes >= ops else 'operations')


def scan_bytes(n_rows, dim, n_queries, k):
    """Bytes an exact scan of an int8 gallery must move, each once: the
    int8 rows, a float32 scale and norm per row, the float32 query rows
    and the k (distance, index) results per query."""
    return n_rows * dim + 8 * n_rows + 4 * n_queries * dim + \
        8 * n_queries * k


CATEGORIES = ('conv2d_int8', 'conv_gemm', 'elementwise', 'reduction',
              'cast_copy', 'memcpy', 'collective', 'other')

# name fragments per category, tried in order after conv2d_int8
_FRAGMENTS = (
    ('collective', ('nccl', 'allreduce', 'all_reduce', 'allgather',
                    'all_gather', 'broadcast', 'reducescatter', 'gloo',
                    'c10d')),
    ('memcpy', ('memcpy', 'memset')),
    ('conv_gemm', ('conv', 'gemm', 'cudnn', 'cublas', 'cutlass', 'xmma',
                   'wgrad', 'dgrad', 'fprop', 'sm90_', 'sm80_', 'aten::mm',
                   'aten::bmm', 'aten::addmm', 'aten::matmul',
                   'aten::linear', 'mkldnn')),
    ('cast_copy', ('copy', 'aten::to', 'contiguous')),
    ('reduction', ('reduce', 'aten::sum', 'aten::mean', 'aten::amax',
                   'aten::max', 'aten::min', 'aten::norm', 'softmax',
                   'aten::var', 'aten::std', 'aten::topk', 'aten::sort',
                   'argmax', 'argmin', 'aten::cumsum', 'aten::prod',
                   'aten::all', 'aten::any')),
    ('elementwise', ('elementwise', 'aten::', 'index', 'scatter',
                     'gather', 'where', 'fill')),
)


def category(name):
    """One of ``CATEGORIES`` for a kernel name."""
    low = name.lower()
    if 'conv2d_int8' in low:
        return 'conv2d_int8'
    for cat, frags in _FRAGMENTS:
        if any(f in low for f in frags):
            return cat
    return 'other'


def rollup(kernels):
    """{category: device seconds} over (name, seconds) pairs."""
    cats = dict.fromkeys(CATEGORIES, 0.0)
    for name, sec in kernels:
        cats[category(name)] += sec
    return cats
