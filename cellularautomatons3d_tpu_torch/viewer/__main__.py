"""python -m cellularautomatons3d_tpu_torch.viewer [--port 8000] [--grid 64]
[--device cuda|cpu] [--mesh N] ..."""

import argparse

from .server import serve


def main():
    p = argparse.ArgumentParser(description="interactive CA viewer")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--grid", type=int, default=64)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--preset", type=str, default=None)
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the Engine runs: the card (hand kernels), or the CPU "
        "(their plain torch versions)",
    )
    p.add_argument(
        "--mesh", type=int, default=0, metavar="N",
        help="shard the engine over an N-device 1-D mesh: N shards on the CPU "
        "with --device cpu, else the cards cuda:0 .. cuda:N-1 (raises with the "
        "card count when there are fewer)",
    )
    args = p.parse_args()
    overrides = dict(grid_size=args.grid, width=args.width, height=args.height)
    if args.mesh:
        overrides["mesh_devices"] = args.mesh
    if args.preset:
        from ..models.presets import PRESETS

        overrides.update(PRESETS[args.preset])
    serve(port=args.port, device=args.device, **overrides)


if __name__ == "__main__":
    main()
