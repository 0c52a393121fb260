"""Score generated shapes against a reference set on the card.

    python -m lion_tpu_torch.eval.compute_score samples.pt ref_val_chair.pt \
        [--norm_box] [--dataset NAME] [--device cuda]

`samples.pt` holds a (B, N, 3) tensor (or a dict with "ref"); the
reference file holds {"ref", "mean", "std"}. Prints the reference's table
and every metric, and appends the table's TSV line to
results/eval_out.csv.
"""
import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("samples", help="generated samples .pt")
    p.add_argument("ref", help="reference set .pt")
    p.add_argument("--norm_box", action="store_true")
    p.add_argument("--dataset", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from . import compute_score
    results = compute_score(args.samples, args.ref, norm_box=args.norm_box,
                            dataset=args.dataset, device=args.device)
    for k, v in sorted(results.items()):
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
