"""Package CLI, the counterpart of the JAX package's ``__main__.py``: the
same commands, arguments, JSON and exit codes.

    python -m multi_modal_transformers_tokenmerge_torch info
    python -m multi_modal_transformers_tokenmerge_torch layout "<sequence dsl>" [compression]
    python -m multi_modal_transformers_tokenmerge_torch config <name> [overrides...]
    python -m multi_modal_transformers_tokenmerge_torch data <file.rec> [more.rec...]

``info`` reports torch's backend (``cuda`` when a card is visible, else
``cpu``) and its devices.
"""

import json
import sys


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    cmd = argv.pop(0) if argv else "info"

    if cmd == "info":
        import torch
        from . import __version__
        from .models.presets import PRESETS
        if torch.cuda.is_available():
            backend = "cuda"
            devices = [f"cuda:{i} {torch.cuda.get_device_name(i)}"
                       for i in range(torch.cuda.device_count())]
        else:
            backend, devices = "cpu", ["cpu"]
        print(json.dumps({
            "version": __version__,
            "backend": backend,
            "devices": devices,
            "presets": sorted(PRESETS),
        }, indent=2))
        return 0

    if cmd == "layout":
        if not argv:
            print("usage: ... layout '<sequence>' ['<compression>']",
                  file=sys.stderr)
            return 2
        from .sequence.layout import SequenceLayout
        layout = SequenceLayout.from_strings(argv[0],
                                             argv[1] if len(argv) > 1 else None)
        print(json.dumps({
            "total_tokens": layout.total_tokens,
            "sets": [{"kind": s.kind, "tokens": s.num_tokens,
                      "timestep": s.timestep,
                      "compressed_per_layer": s.compressed_per_layer}
                     for s in layout.sets],
            "mask_density": round(float(layout.attention_mask().mean()), 4),
            "readout_positions": layout.modality_index("readouts").tolist(),
        }, indent=2))
        return 0

    if cmd == "config":
        if not argv:
            print("usage: ... config <name> [key=value ...]", file=sys.stderr)
            return 2
        import dataclasses
        from .core.yaml_loader import load_config
        cfg = load_config(argv[0], argv[1:])
        print(json.dumps(dataclasses.asdict(cfg), indent=2, default=str))
        return 0

    if cmd == "data":
        if not argv:
            print("usage: ... data <file.rec> [more.rec ...]",
                  file=sys.stderr)
            return 2
        from .utils.recordio import _read_header
        total, rec_size, schema0 = 0, None, None
        files = []
        for path in argv:
            schema, rs, num, _ = _read_header(path)
            if schema0 is None:
                schema0, rec_size = schema, rs
            compatible = schema == schema0 and rs == rec_size
            files.append({"path": path, "records": num,
                          "bytes_per_record": rs,
                          "compatible_with_first": compatible})
            total += num
        print(json.dumps({
            "files": files,
            "total_records": total,
            "schema": [{"field": n, "shape": list(s), "dtype": d}
                       for n, s, d in schema0],
            "is_episode_file": {"image", "action", "text_ids", "step"
                                }.issubset({n for n, _, _ in schema0}),
        }, indent=2))
        return 0

    print(f"unknown command {cmd!r}; one of: info, layout, config, data",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
