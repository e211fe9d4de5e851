"""The sharded checkpoint (``TPU.CKPT_FORMAT: orbax`` in the port: a
``torch.distributed.checkpoint`` directory ``*.dcp``) on gloo ranks (one
process each, on the CPU):

* round trips (1, 2) -> one process, one process -> (1, 2) and
  (1, 2) -> (2, 2), bitwise, each checking both halves of every
  class-sharded tensor (class slices saved as plain tensors under one key
  load back as one rank's half, silently: the placement must travel);
* the loaded tree equal, bitwise, to pps_tpu's own orbax round trip of
  the same state;
* (``train_model`` preempted and resumed from a ``.dcp`` directory on
  two ranks: tests/test_torch_port_ckpt_driver.py)
* ``test_net`` on a ``.dcp`` directory equal to ``test_net`` on the pkl;
* a pps_tpu ``.orbax`` path raises, naming pkl."""

import os
import shutil

import numpy as np
import pytest
import torch

from pps_tpu_torch import config as tcfg
from pps_tpu_torch.data import catalog as tcatalog
from pps_tpu_torch.engine import checkpoint as tckpt
from pps_tpu_torch.engine import test as ttest
from pps_tpu_torch.engine import train as ttrain
from pps_tpu_torch.models.model import build_model as tbuild

from _torch_port_dist import Ranks, decoder
# the tmp_path that frees each test's checkpoint files when it ends
from _torch_port_variants_common import tmp_path  # noqa: F401
from test_torch_port_data import write_coco

K_LOGITS = 16
SHARDED = ['crm_fc8c_b', 'crm_fc8c_w', 'pps_fc_b', 'pps_fc_w']
RAW_HW = (48, 20)
TINY = [
    'MODEL.TYPE', 'generalized_reid',
    'MODEL.CONV_BODY', 'ResNet.add_ResNet50_conv5_body',
    'MODEL.NUM_CLASSES', '9', 'MODEL.USE_BN', 'True',
    'MODEL.DTYPE', 'float32',
    'FAST_RCNN.ROI_BOX_HEAD', 'pps_heads.add_pps_part_head',
    'RESNETS.RES5_STRIDE', '1', 'TRAIN.FREEZE_AT', '0',
    'REID.SCALE', '(32, 96)', 'REID.BPM_STRIP_NUM', '3',
    'REID.BPM_DIM', '16', 'REID.CRM', 'True',
    'REID.TRIPLET_LOSS', 'True', 'REID.TRIPLET_LOSS_CROSS', 'True',
    'REID.NORMALIZE_FEATURE', 'True', 'REID.MAX_AVE_FEATURE', 'True']
@pytest.fixture(autouse=True)
def _fresh_port_cfg():
    tcfg.reset_cfg()
    yield
    tcfg.reset_cfg()


def _tree(seed):
    """A train state in pps_tpu's layout (HWIO convs), numpy: replicated
    params, class-sharded FCs of 16 logits, BN state, momentum."""
    rng = np.random.RandomState(seed)
    shapes = {'conv1_w': (3, 3, 3, 4), 'res_conv1_bn_s': (4,),
              'pps_fc_w': (7, 16, K_LOGITS), 'pps_fc_b': (7, K_LOGITS),
              'crm_fc8c_w': (16, K_LOGITS), 'crm_fc8c_b': (K_LOGITS,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    return {'params': params,
            'state': {'res_conv1_bn_rm': rng.randn(4).astype(np.float32)},
            'opt': {'momentum': {k: rng.randn(*s).astype(np.float32)
                                 for k, s in shapes.items()}}}


class _OnCpu(object):
    device = torch.device('cpu')


def _port(tree):
    """pps_tpu's layout -> the port's (params_from_numpy), as numpy."""
    p, s, o = tckpt.params_from_numpy(_OnCpu(), tree['params'],
                                      tree['state'], tree['opt'])
    return {'params': {k: v.numpy() for k, v in p.items()},
            'state': {k: v.numpy() for k, v in s.items()},
            'opt': {'momentum': {k: v.numpy()
                                 for k, v in o['momentum'].items()}}}


def _as_torch(tree):
    return {part: {k: (torch.tensor(v) if not isinstance(v, dict) else
                       {n: torch.tensor(a) for n, a in v.items()})
                   for k, v in t.items()} for part, t in tree.items()}


def _assert_bitwise(got, want):
    assert sorted(got) == sorted(want)
    for part in want:
        assert sorted(got[part]) == sorted(want[part]), part
        for k, w in want[part].items():
            if isinstance(w, dict):
                _assert_bitwise({k: got[part][k]}, {k: w})
                continue
            g = got[part][k]
            g = g.numpy() if torch.is_tensor(g) else g
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.fixture(scope='module')
def rounds(tmp_path_factory):
    """(1, 2) ranks load a directory written by one process and save
    another; four (2, 2) ranks then load the (1, 2) save; one process
    loads it too; pps_tpu's orbax round trip of the same state."""
    root = tmp_path_factory.mktemp('dcp')
    jax_tree, other = _tree(0), _tree(1)
    a, b = _port(jax_tree), _port(other)
    one_dir, two_dir = str(root / 'one.dcp'), str(root / 'two.dcp')
    tckpt.save_checkpoint_dcp(one_dir, _as_torch(b), block=True)
    common = {'num_logits': K_LOGITS, 'sharded': SHARDED}
    # the (2, 2) ranks start at once and wait for the (1, 2) save
    two = Ranks('dcp', 2, str(root / 'r2'), dict(
        common, mesh_shape=(1, 2), tree=a, load=one_dir, save=two_dir),
        timeout=90)
    four = Ranks('dcp', 4, str(root / 'r4'), dict(
        common, mesh_shape=(2, 2), tree=a, load=two_dir), timeout=90)
    try:
        # pps_tpu's own sharded round trip of the same state, meanwhile
        from pps_tpu.engine import checkpoint as jckpt
        jdir = str(root / 'jax.orbax')
        jckpt.save_checkpoint_orbax(jdir, jax_tree)
        jckpt.wait_for_orbax()
        back = jckpt.load_checkpoint_orbax(jdir, jax_tree)
        jax_back = _port({p: {k: (np.asarray(v) if not isinstance(v, dict)
                                  else {n: np.asarray(x)
                                        for n, x in v.items()})
                              for k, v in t.items()}
                          for p, t in back.items()})
        got_two, got_four = two.results(), four.results()
        loaded = tckpt.load_checkpoint_dcp(two_dir, _as_torch(
            {p: {k: (np.zeros_like(v) if not isinstance(v, dict) else
                     {n: np.zeros_like(x) for n, x in v.items()})
                 for k, v in t.items()} for p, t in a.items()}))
    finally:
        two.kill()
        four.kill()
        shutil.rmtree(str(root), ignore_errors=True)
    return {'a': a, 'b': b, 'two': got_two, 'four': got_four,
            'loaded': loaded,
            'jax_back': jax_back}


def _halves(tree, n_model, index):
    out = {}
    for n in SHARDED:
        t = tree['params'][n]
        per = t.shape[-1] // n_model
        out[n] = t[..., index * per:(index + 1) * per]
    return out


@pytest.mark.parametrize('direction', ['1x2_to_one', 'one_to_1x2',
                                       '1x2_to_2x2'])
def test_dcp_round_trip_is_bitwise(rounds, direction):
    if direction == '1x2_to_one':
        _assert_bitwise(rounds['loaded'], rounds['a'])
        return
    ranks, want, m = ((rounds['two'], rounds['b'], 2)
                      if direction == 'one_to_1x2'
                      else (rounds['four'], rounds['a'], 2))
    for r, out in enumerate(ranks):
        _assert_bitwise(out['loaded'], want)
        # each rank loaded its own half of every class-sharded tensor
        for n, half in _halves(want, m, r % m).items():
            np.testing.assert_array_equal(out['local'][n], half, err_msg=n)
            assert half.shape[-1] == K_LOGITS // m


def test_both_halves_differ_so_a_lost_placement_would_fail(rounds):
    """The trap: a half loaded where the whole should be, or rank 1's half
    where rank 0's should be, fails the checks above."""
    for n in SHARDED:
        lo, hi = (_halves(rounds['a'], 2, i)[n] for i in (0, 1))
        assert not np.array_equal(lo, hi), n


def test_dcp_round_trip_equals_pps_tpu_orbax_round_trip(rounds):
    _assert_bitwise(rounds['loaded'], rounds['jax_back'])


def test_dcp_directory_needs_its_metadata(tmp_path):
    (tmp_path / 'model_epoch3.dcp').mkdir()
    (tmp_path / 'model_epoch1.dcp').mkdir()
    tckpt.save_checkpoint_dcp(str(tmp_path / 'model_epoch1.dcp'),
                              _as_torch(_port(_tree(2))), block=True)
    # an unfinished write (no .metadata) is no resume point
    assert tckpt.find_resume_checkpoint(str(tmp_path))[1:] == (1, 0)
    with pytest.raises(FileNotFoundError, match='metadata'):
        tckpt.load_checkpoint_dcp(str(tmp_path / 'model_epoch3.dcp'),
                                  _as_torch(_port(_tree(2))))


def test_test_net_on_dcp_equals_test_net_on_pkl(tmp_path):
    imdir, ann = write_coco(tmp_path / 'test', 'test', 3, 2, hw=RAW_HW,
                            with_marks=True)
    tcatalog.register_dataset('port_dcp_test', imdir, ann)
    tcfg.merge_cfg_from_list(TINY + ['TEST.IMS_PER_BATCH', '4'])
    model = tbuild(tcfg.cfg, device='cpu')
    params, state = model.init(torch.Generator().manual_seed(5))
    params = {k: v + 0.01 * torch.randn(v.shape,
                                        generator=torch.Generator()
                                        .manual_seed(6))
              for k, v in params.items()}
    pkl, dcp_dir = str(tmp_path / 'w.pkl'), str(tmp_path / 'w.dcp')
    tckpt.save_checkpoint(pkl, model, params, state)
    tckpt.save_checkpoint_dcp(dcp_dir, {'params': params, 'state': state},
                              cfg=tcfg.cfg, block=True)
    assert os.path.isfile(dcp_dir + '.cfg.yaml')
    feats = {}
    for name, w in (('pkl', pkl), ('dcp', dcp_dir)):
        feats[name], _ = ttest.test_net(tcfg.cfg, w, 'port_dcp_test',
                                        decode_fn=decoder(RAW_HW),
                                        device='cpu')
    assert feats['dcp'].shape == (6, 112)
    np.testing.assert_array_equal(feats['dcp'], feats['pkl'])


def test_an_orbax_path_raises_naming_pkl(tmp_path):
    tcfg.merge_cfg_from_list(TINY)
    for call in (lambda: ttest.test_net(tcfg.cfg, str(tmp_path / 'w.orbax'),
                                        'port_dcp_test', device='cpu'),
                 lambda: tckpt.load_checkpoint_dcp(
                     str(tmp_path / 'm.orbax'), {})):
        with pytest.raises(ValueError, match='pkl is the format both'):
            call()
    (tmp_path / 'out').mkdir()
    (tmp_path / 'out' / 'model_epoch2.orbax').mkdir()
    with pytest.raises(ValueError, match='orbax'):
        ttrain.create_model(tcfg.cfg, str(tmp_path / 'out'), device='cpu')
