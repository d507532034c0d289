"""Architecture-zoo tour on the PyTorch port: one reduced-config step of
every arch.

    PYTHONPATH=src python examples/arch_zoo_torch.py [--arch granite-3-8b] [--device cpu]

The twin of ``examples/arch_zoo.py``: each --arch's REDUCED config runs one
train step (and a prefill and a decode step for the LMs; one forward for
the recsys models), printing loss/shape/params. Runs on ``cuda`` unless
``--device cpu`` is given.
"""

import argparse
import sys

sys.path.insert(0, "src")

import torch  # noqa: E402

from repro_torch.common.treeutil import tree_leaves  # noqa: E402
from repro_torch.configs import get_arch, list_archs  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402


def _n_params(params) -> int:
    return sum(x.numel() for x in tree_leaves(params))


def run_lm(arch, dev):
    from repro_torch.models import transformer as tf

    cfg = get_arch(arch).make_reduced()
    gen = torch.Generator(dev).manual_seed(0)
    init, step, opt_init = tf.make_train_step(cfg, lr=1e-3)
    params = init(gen)
    opt = opt_init(params)
    toks = torch.randint(0, cfg.vocab, (4, 16), generator=gen, device=dev)
    params, opt, loss = step(params, opt, toks, toks)
    logits, cache = tf.prefill(cfg, params, toks, max_len=24)
    logits, cache = tf.decode_step(cfg, params, cache, torch.argmax(logits, -1))
    print(f"{arch:24s} loss={float(loss):7.3f} decode_logits={tuple(logits.shape)} "
          f"params={_n_params(params)/1e6:.2f}M")
    return float(loss)


def run_gnn(arch, dev):
    from repro_torch.models import gnn

    cfg = get_arch(arch).make_reduced()
    gen = torch.Generator(dev).manual_seed(0)
    n, e = 128, 512
    x = torch.randn((n, cfg.d_in), generator=gen, device=dev)
    src = torch.randint(0, n, (e,), generator=gen, device=dev)
    dst = torch.randint(0, n, (e,), generator=gen, device=dev)
    y = torch.randint(0, cfg.n_classes, (n,), generator=gen, device=dev)
    init, step, opt_init = gnn.make_train_step(cfg)
    params = init(gen)
    opt = opt_init(params)
    params, opt, loss = step(params, opt, x, src, dst, y,
                             torch.ones((n,), dtype=torch.bool, device=dev))
    print(f"{arch:24s} loss={float(loss):7.3f} nodes={n} edges={e}")
    return float(loss)


def run_recsys(arch, dev):
    from repro_torch.models import recsys as rs

    cfg = get_arch(arch).make_reduced()
    gen = torch.Generator(dev).manual_seed(0)
    b = 32
    ints = lambda hi, shape: torch.randint(0, hi, shape, generator=gen, device=dev)
    if arch == "dlrm-mlperf":
        params = rs.init_dlrm(gen, cfg)
        out = rs.dlrm_forward(cfg, params,
                              torch.randn((b, cfg.n_dense), generator=gen, device=dev),
                              ints(50, (b, cfg.n_sparse)))
    elif arch == "deepfm":
        params = rs.init_deepfm(gen, cfg)
        out = rs.deepfm_forward(cfg, params, ints(40, (b, cfg.n_fields)))
    elif arch == "din":
        params = rs.init_din(gen, cfg)
        hist = ints(cfg.n_items, (b, cfg.seq_len))
        out = rs.din_forward(cfg, params, hist, torch.ones_like(hist, dtype=torch.bool),
                             ints(cfg.n_items, (b,)))
    else:  # bert4rec
        params = rs.init_bert4rec(gen, cfg)
        items = ints(cfg.n_items, (b, cfg.seq_len))
        out = rs.bert4rec_encode(cfg, params, items,
                                 torch.ones_like(items, dtype=torch.bool))[:, -1, 0]
    print(f"{arch:24s} out_mean={float(torch.mean(out)):7.3f} "
          f"params={_n_params(params)/1e6:.2f}M")
    return float(torch.mean(out))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list_archs() + [None])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {}
    for arch in ([args.arch] if args.arch else list_archs()):
        family = get_arch(arch).family
        if family == "lm":
            out[arch] = run_lm(arch, dev)
        elif family == "gnn":
            out[arch] = run_gnn(arch, dev)
        elif family == "recsys":
            out[arch] = run_recsys(arch, dev)
        else:
            print(f"{arch:24s} (RPQ itself — see quickstart_torch.py)")
    return out


if __name__ == "__main__":
    main()
