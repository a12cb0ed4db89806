"""Context-compacted readback (round 5): the device ships counters only at
the positions emit_window can read — CTX-enabled context positions (plus
boundary guards) instead of every ref-C/G position.

Safety net structure:
- the numpy/jnp mask twins must agree bit-for-bit (the device gathers by
  the jnp mask, the host scatters by the numpy one);
- the numpy mask must be a superset of the positions emit_window reads
  (its per-position reads are gated by ctx_kept = keep_vec[ctype]);
- the grouped-slot mask must equal per-slot masks (no cross-slot bleed);
- the group program, run on XLA:CPU, round-trips the compaction geometry
  end to end (test_group_dispatch + the CLI e2e below); chip_smoke.py
  does the same on the GPU.
"""
import subprocess
import sys
import os

import numpy as np
import pytest

from methyldackel_tpu.config import Config
from methyldackel_tpu.ops import semantics as sem
from methyldackel_tpu.parallel.device import (_ctx_code, _ctx_mask_np,
                                              _ctx_mask_jnp, _ncand_bucket,
                                              _round_up)

REF_C, REF_G = ord("C"), ord("G")


def _random_bits(rng, n, p=0.25):
    return rng.random(n) < p


@pytest.mark.parametrize("ctx", list(range(8)))
@pytest.mark.parametrize("slot", [512, 1024, (1536, 1024)])
def test_mask_twins_agree(ctx, slot):
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(1234 + ctx)
    period = slot[0] if isinstance(slot, tuple) else slot
    W = 3 * period
    cb = _random_bits(rng, W)
    gb = _random_bits(rng, W) & ~cb
    ref = _ctx_mask_np(cb, gb, ctx, slot)
    got = np.asarray(jax.jit(
        lambda c, g: _ctx_mask_jnp(c, g, ctx, slot))(jnp.asarray(cb),
                                                     jnp.asarray(gb)))
    np.testing.assert_array_equal(got, ref)


def _cfg_for(ctx, cytosine=False):
    cfg = Config()
    cfg.keepCpG = bool(ctx & 1)
    cfg.keepCHG = bool(ctx & 2)
    cfg.keepCHH = bool(ctx & 4)
    cfg.cytosine_report = cytosine
    return cfg


def test_ctx_code():
    assert _ctx_code(Config()) == 1  # default: CpG only
    assert _ctx_code(_cfg_for(7)) == 7
    assert _ctx_code(_cfg_for(3)) == 3
    assert _ctx_code(_cfg_for(1, cytosine=True)) == 7  # all C/G


@pytest.mark.parametrize("ctx", [1, 2, 4, 3, 5, 6, 7])
@pytest.mark.parametrize("woff_rel", [0, -2])
def test_mask_superset_of_emit_reads(ctx, woff_rel):
    """Every position emit_window reads (keep_vec[ctype] over the window's
    ref slice, engine/extract.emit_window) must be in the shipped mask —
    including coords whose context depends on the 2 leading ref bases
    before win_start (bitmap can't see them; guard) and coords near the
    bitmap truncation at wpad (guard)."""
    rng = np.random.default_rng(99)
    wlen = 1500
    wpad = _round_up(wlen + 16, 512)
    # ref_window as the engine slices it: [lpos2, win_end + 10)
    ref = rng.choice(np.frombuffer(b"ACGT", np.uint8),
                     size=wlen - woff_rel + 10)
    # the v3_refbits mapping: bit i <-> ref[i - woff_rel]
    idx = np.arange(wpad, dtype=np.int64) - woff_rel
    inr = (idx >= 0) & (idx < len(ref))
    rbw = np.where(inr, ref[np.clip(idx, 0, len(ref) - 1)], 0)
    mask = _ctx_mask_np(rbw == REF_C, rbw == REF_G, ctx, wpad)

    ct, _cd = sem.classify_context(ref)
    keep_vec = np.array([(ctx & 1) != 0, (ctx & 2) != 0, (ctx & 4) != 0,
                         False])
    for w in range(wlen):
        if keep_vec[ct[w - woff_rel]]:
            assert mask[w], (w, ctx, woff_rel)


def test_mask_slot_independence():
    """Grouped-slot mask == per-slot masks concatenated: shifts never pull
    meaningful bits across slot boundaries (the inter-slot guard tiles
    carry no bits, and the guard bands use the shift-free C|G rule)."""
    rng = np.random.default_rng(7)
    wpad1, S, K = 1024, 1024 + 512, 3
    cb = np.zeros(K * S, bool)
    gb = np.zeros(K * S, bool)
    for k in range(K):
        cb[k * S: k * S + wpad1] = _random_bits(rng, wpad1)
        gb[k * S: k * S + wpad1] = _random_bits(rng, wpad1) & \
            ~cb[k * S: k * S + wpad1]
    for ctx in (1, 3, 5, 7):
        grp = _ctx_mask_np(cb, gb, ctx, (S, wpad1))
        for k in range(K):
            single = _ctx_mask_np(cb[k * S:(k + 1) * S],
                                  gb[k * S:(k + 1) * S], ctx, (S, wpad1))
            np.testing.assert_array_equal(grp[k * S:(k + 1) * S], single,
                                          err_msg=f"slot {k} ctx {ctx}")


def test_ncand_bucket_ladder():
    w = 1 << 20
    fracs = [1, 3, 6, 10]
    buckets = [_round_up(max(w * f // 16, 128), 128) for f in fracs]
    assert _ncand_bucket(1, w) == buckets[0]
    assert _ncand_bucket(buckets[0], w) == buckets[0]
    assert _ncand_bucket(buckets[0] + 1, w) == buckets[1]
    assert _ncand_bucket(w // 2, w) == buckets[3]
    assert _ncand_bucket(buckets[3] + 1, w) == 0  # above the 5/8 cap
    # floor forces the bucket up (process-global high-water convergence)
    assert _ncand_bucket(1, w, floor=buckets[1]) == buckets[1]


def test_cli_context_combos_group_path(tmp_path):
    """CLI byte-identity host vs jax with CHG/CHH/mergeContext through the
    grouped dispatch (MDTPU_BATCH_WINDOWS=3): the group program
    round-trips the context-compacted readback geometry on CPU, so a
    wrong mask surfaces as a byte diff here."""
    from methyldackel_tpu.utils.simulate import write_synthetic_input
    from methyldackel_tpu.io.bam import BamFile
    from methyldackel_tpu.io.bai import build_bai

    fa, bam = write_synthetic_input(str(tmp_path), 400, 100, 3 * 5632,
                                    seed=11)
    build_bai(BamFile(bam), bam + ".bai")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ,
               PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               MDTPU_BATCH_WINDOWS="3")
    variants = [
        ["--CHH", "--CHG"],
        ["--noCpG", "--CHH"],
        ["--mergeContext"],
        ["--CHG", "--mergeContext"],
    ]
    for vi, extra in enumerate(variants):
        outs = {}
        for eng in ("host", "jax"):
            env["MDTPU_ENGINE"] = eng
            od = tmp_path / f"ctxc_{eng}_{vi}"
            od.mkdir(exist_ok=True)
            cmd = [sys.executable, "-m", "methyldackel_tpu.cli", "extract",
                   "--chunkSize", "5632", *extra, fa, bam,
                   "-o", str(od / "o")]
            r = subprocess.run(cmd, env=env, capture_output=True, text=True)
            assert r.returncode == 0, r.stderr
            outs[eng] = sorted(
                # the track header embeds the opref PATH (engine-specific
                # tmp dir here) — compare data rows only
                (p.name, b"\n".join(
                    l for l in p.read_bytes().split(b"\n")
                    if not l.startswith(b"track ")))
                for p in od.iterdir())
        names_h = [n for n, _ in outs["host"]]
        names_j = [n for n, _ in outs["jax"]]
        assert names_h == names_j and outs["host"] == outs["jax"], extra
