"""The port's hand-written kernels, each with a wrapper that counts its
launches.

``launch_counts()`` gathers those counts for this process.  An entry point
run as a program writes them at exit to the file named by
``$PPS_TPU_TORCH_LAUNCH_COUNTS`` (``write_launch_counts``), so a driver
that starts it as a child process reads which kernels that process
launched.
"""

import json
import os

LAUNCH_COUNTS_ENV = 'PPS_TPU_TORCH_LAUNCH_COUNTS'


def launch_counts():
    """{kernel name: launches counted by its wrapper in this process}."""
    from pps_tpu_torch.kernels import conv2d_int8, zero_even
    return {'conv2d_int8': conv2d_int8.launches,
            'zero_even': zero_even.launches}


def reset_launch_counts():
    """Set every kernel's launch count in this process to 0."""
    from pps_tpu_torch.kernels import conv2d_int8, zero_even
    conv2d_int8.launches = 0
    zero_even.launches = 0


def write_launch_counts():
    """Write ``launch_counts()`` as JSON to ``$PPS_TPU_TORCH_LAUNCH_COUNTS``
    when it is set (through a temporary name, so a reader never sees half a
    file)."""
    path = os.environ.get(LAUNCH_COUNTS_ENV)
    if not path:
        return
    tmp = '{}.tmp{}'.format(path, os.getpid())
    with open(tmp, 'w') as f:
        json.dump(launch_counts(), f)
    os.replace(tmp, path)
