"""The train-step graph dump (``PPS_TPU_DUMP_JAXPR``, the counterpart of
pps_tpu's ``train_step.jaxpr.txt``): ``train_model`` writes
``train_step.graph.txt``, the one-device step at the global batch traced
on fake tensors.  The trace runs no step, reads no batch and changes no
parameter: a run with the dump trains on the same batches to the same
final weights, bitwise, as a run without it."""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor

from pps_tpu_torch import config as tcfg
from pps_tpu_torch.data import catalog as tcatalog
from pps_tpu_torch.engine import train as ttrain
from pps_tpu_torch.models.model import build_model
from pps_tpu_torch.parallel import train_step as tts
from pps_tpu_torch.solver import optimizer as topt
from pps_tpu_torch.utils.io import load_object

from _torch_port_dist import decoder
# the tmp_path that frees each test's checkpoint files when it ends
from _torch_port_variants_common import tmp_path  # noqa: F401
from test_torch_port_ckpt_sharded import RAW_HW, TINY
from test_torch_port_data import write_coco

TRAIN = TINY + [
    'TRAIN.DATASETS', "('port_graph_trainval',)", 'TRAIN.IMS_PER_BATCH', '8',
    'TRAIN.USE_FLIPPED', 'False', 'SOLVER.MAX_ITER', '1',
    'REID.TRIPLET_LOSS_START', '0', 'REID.P', '4', 'REID.K', '2']


@pytest.fixture(autouse=True)
def _fresh_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


def _record_steps(monkeypatch):
    """Every call of a train step made by make_train_step: whether its
    data was real (not a fake tensor) and its labels."""
    calls = []
    make = tts.make_train_step

    def recording(*a, **k):
        step = make(*a, **k)

        def wrapped(ts, batch, *r, **kw):
            real = not isinstance(batch['labels_int32'], FakeTensor)
            calls.append((real, batch['labels_int32'].tolist()
                          if real else None))
            return step(ts, batch, *r, **kw)
        return wrapped
    monkeypatch.setattr(tts, 'make_train_step', recording)
    return calls


def test_graph_dump_writes_the_step_and_changes_nothing(tmp_path,
                                                        monkeypatch,
                                                        caplog):
    imdir, ann = write_coco(tmp_path / 'trainval', 'trainval', 4, 4,
                            hw=RAW_HW)
    tcatalog.register_dataset('port_graph_trainval', imdir, ann)
    tcfg.merge_cfg_from_list(TRAIN)
    runs = {}
    for name, dump in (('dump', True), ('plain', False)):
        if dump:
            monkeypatch.setenv('PPS_TPU_DUMP_JAXPR', '1')
        else:
            monkeypatch.delenv('PPS_TPU_DUMP_JAXPR', raising=False)
        calls = _record_steps(monkeypatch)
        out = str(tmp_path / name)
        with caplog.at_level('INFO', logger='pps_tpu_torch.engine.train'):
            ck = ttrain.train_model(tcfg.cfg, output_dir=out,
                                    decode_fn=decoder(RAW_HW), num_workers=1,
                                    device='cpu')
        runs[name] = (calls, load_object(ck['final'])['blobs'], out)
        monkeypatch.undo()
    calls, final, out = runs['dump']
    graph = (tmp_path / 'dump' / 'train_step.graph.txt').read_text()
    assert 'convolution' in graph and 'def forward' in graph
    nodes = [r.getMessage() for r in caplog.records
             if 'train_step.graph.txt' in r.getMessage()]
    assert len(nodes) == 1
    assert int(nodes[0].split('(')[1].split()[0]) > 1000
    assert not (tmp_path / 'plain' / 'train_step.graph.txt').exists()
    # the traced step saw fake tensors only; the real steps are the plain
    # run's, on the same batches, to the same weights
    assert [c for c in calls if not c[0]] == [(False, None)]
    real = [c for c in calls if c[0]]
    assert real == runs['plain'][0] and len(real) == 2
    assert sorted(final) == sorted(runs['plain'][1])
    for k, v in final.items():
        np.testing.assert_array_equal(v, runs['plain'][1][k], err_msg=k)


def test_graph_dump_leaves_the_parameters_as_they_were(tmp_path):
    tcfg.merge_cfg_from_list(TRAIN)
    model = build_model(tcfg.cfg, device='cpu')
    params, state = model.init(torch.Generator().manual_seed(0))
    ts = {'params': params, 'state': state,
          'opt': topt.init_opt_state(params)}
    before = {k: v.clone() for k, v in params.items()}
    nodes = ttrain.dump_train_graph(
        model, tcfg.cfg, topt.make_param_meta(params, tcfg.cfg), None, 8, ts,
        str(tmp_path))
    assert nodes > 1000
    for k, v in before.items():
        assert ts['params'][k] is params[k]
        assert torch.equal(params[k], v), k
    assert all(not isinstance(v, FakeTensor) for v in params.values())
