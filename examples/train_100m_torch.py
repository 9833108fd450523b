"""End-to-end training on the PyTorch port: a ~100M-param xLSTM trained
with the full production substrate engaged, as `examples/train_100m.py`
runs it on the JAX package:

  * data shards fetched from a billing-faithful ObjectStore through the
    dollar-aware EgressCache (the paper's technique in the data path),
  * AdamW, grad microbatching, per-layer remat,
  * atomic checkpoints + crash-resume,
  * a final egress audit against the exact offline reference.

    PYTHONPATH=src python examples/train_100m_torch.py --steps 300      # card
    PYTHONPATH=src python examples/train_100m_torch.py --device cpu --smoke

(--smoke trains the reduced config in seconds.)
"""
import argparse
import tempfile

from repro_torch.configs import get_config
from repro_torch.core import resolve_device
from repro_torch.egress.cache import EgressCache
from repro_torch.egress.store import ObjectStore
from repro_torch.models.common import tree_leaves
from repro_torch.models.registry import get_model
from repro_torch.train.data import DataPipeline, ShardedTokenDataset
from repro_torch.train.driver import DriverConfig, TrainDriver
from repro_torch.train.optim import OptimizerConfig, make_optimizer
from repro_torch.train.trainer import make_train_step


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--policy", default="gdsf")
    args = ap.parse_args()
    device = resolve_device(args.device)

    cfg = get_config("xlstm-125m", smoke=args.smoke)
    model = get_model(cfg)
    print(f"arch: {cfg.name} ({cfg.num_layers}L d={cfg.d_model}) on {device}")

    params = model.init(0, device=device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"params: {n_params/1e6:.1f}M")

    opt = make_optimizer(OptimizerConfig(name="adamw", lr=3e-4))
    opt_state = opt.init(params)
    step = make_train_step(model, opt, microbatches=2)

    # billing-faithful data path (the paper's substrate)
    store = ObjectStore("gcs_internet")
    ds = ShardedTokenDataset(store, num_shards=64,
                             shard_tokens=args.batch * args.seq * 4,
                             vocab=cfg.vocab_size).register()
    cache = EgressCache(store, capacity_bytes=8 * args.batch * args.seq * 4 * 4,
                        policy=args.policy)
    pipe = DataPipeline(ds, cache, batch_size=args.batch, seq_len=args.seq)

    with tempfile.TemporaryDirectory() as ckdir:
        driver = TrainDriver(
            DriverConfig(checkpoint_dir=ckdir, checkpoint_every=100,
                         max_steps=args.steps),
            step, params, opt_state, pipe, device=device)
        if driver.resume():
            print(f"resumed from step {driver.step}")
        out = driver.run()
        print(f"\ntrained {out['steps']} steps; "
              f"loss {driver.losses[0]:.3f} -> {out['final_loss']:.3f}")

    print("\n--- egress audit (paper's offline reference) ---")
    print(driver.pipeline.cache.audit().summary())
    print(f"store meter: {store.meter.snapshot()}")


if __name__ == "__main__":
    main()
