"""Index checkpointing: directory-based save/load of the full engine state.

The reference checkpoints via pickle only (/root/reference/src/main.cpp:35-54;
docs/source/tutorial.rst:292-305) and restores the FULL engine including
posting lists. Here the canonical state is a dict of numpy arrays + a JSON
manifest, written per-array so billion-scale code arrays stream to disk
without a monolithic pickle buffer. ``Rii`` objects also remain fully
picklable (tests/test_rii.py::test_pickle).

Format v2 additionally persists the DERIVED query-path state whose rebuild
dominates a restored big index's first query: the per-row code norms and the virtual-bucket layout
permutation (order/vreal/vstart/counts). ``load_index`` hands these to
the engine as one-shot adoption state — the first ``_ensure_cache`` skips
the norms pass and the argsort+placement pass and only pays the
codes[order] gather + H2D + (cached) compiles. v1 directories still load.
"""

import json
import os

import numpy as np


_MANIFEST = "manifest.json"

# the virtual-layout arrays persisted by format v2 (models/ivf.py
# build_virtual_layout outputs, minus the grouped code/norm copies which are
# rebuilt from `order` by one fancy-gather at load)
_LAYOUT_ARRAYS = ("order", "vreal", "vstart", "counts")


def save_index(engine, path, layout=True):
    """Save a Rii engine to a directory (created if needed).

    layout=True (default) also persists the derived norms + virtual-bucket
    layout so a restored index skips the host layout rebuild on first query.
    The layout is recomputed here from the canonical state (deterministic,
    pure numpy) rather than read back from the device.
    """
    from rii_tpu.models.ivf import build_virtual_layout, code_norms_np
    from rii_tpu.models.opq import OPQ

    os.makedirs(path, exist_ok=True)
    fq = engine.fine_quantizer
    manifest = {
        "format": "rii_tpu.index.v2",
        "codec": type(fq).__name__,
        "M": fq.M,
        "Ks": fq.Ks,
        "Ds": fq.Ds,
        "seed": fq.seed,
        "verbose": engine.verbose,
        "N": engine.N,
        "nlist": engine.nlist,
        "scan_mode": getattr(engine, "scan_mode", "auto"),
        "cap_reserve": int(getattr(engine, "_cap_reserve", 0)),
        "threshold_coeffs": (
            None if engine.threshold is None
            else [float(c) for c in np.poly1d(engine.threshold).coeffs]
        ),
    }
    arrays = {"codewords": fq.codewords}
    if isinstance(fq, OPQ):
        arrays["rotation_matrix"] = fq.rotation_matrix
    if engine.N > 0:
        arrays["codes"] = engine._consolidated_codes()
        arrays["assignments"] = engine._assignments()
    if engine.nlist > 0:
        arrays["coarse_centers"] = engine._centers
    if layout and engine.N > 0:
        cw = np.asarray(fq.codewords, dtype=np.float32)
        norms = code_norms_np(cw, arrays["codes"])
        arrays["norms"] = norms
        if engine.nlist > 0:
            # the headroom the engine derives at cache build (rii.py
            # _build_cache); recorded so load-time adoption only fires when
            # the restored engine would derive the same layout
            h = 0.125
            if engine._cap_reserve > engine.N > 0:
                h = max(h, engine._cap_reserve / engine.N - 1.0)
            ul = build_virtual_layout(arrays["codes"], norms,
                                      arrays["assignments"], engine.nlist,
                                      headroom=h)
            for name in _LAYOUT_ARRAYS:
                arrays["vl_" + name] = ul[name]
            manifest["layout"] = {
                "headroom": h, "cap_v": ul["cap_v"],
                "nlist_v": ul["nlist_v"], "nlist_v_pad": ul["nlist_v_pad"],
            }
    for name, arr in arrays.items():
        np.save(os.path.join(path, name + ".npy"), arr)
    manifest["arrays"] = sorted(arrays)
    with open(os.path.join(path, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)


def load_index(path, mmap=False):
    """Load a Rii engine saved by :func:`save_index` (format v1 or v2).

    mmap=True maps the code array instead of reading it (np.load mmap_mode),
    useful when the host-side copy should stay lazy.
    """
    from rii_tpu import PQ, OPQ, Rii

    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    assert manifest["format"] in ("rii_tpu.index.v1", "rii_tpu.index.v2")

    def arr(name, mm=False):
        return np.load(os.path.join(path, name + ".npy"),
                       mmap_mode="r" if mm else None)

    cls = {"PQ": PQ, "OPQ": OPQ}[manifest["codec"]]
    fq = cls(M=manifest["M"], Ks=manifest["Ks"], verbose=manifest["verbose"],
             seed=manifest["seed"])
    fq.codewords = arr("codewords")
    fq.Ds = manifest["Ds"]
    if manifest["codec"] == "OPQ":
        fq.rotation_matrix = arr("rotation_matrix")

    e = Rii(fine_quantizer=fq)
    e.scan_mode = manifest.get("scan_mode", "auto")
    e._cap_reserve = int(manifest.get("cap_reserve", 0))
    if "codes" in manifest["arrays"]:
        codes = arr("codes", mm=mmap)
        e._code_chunks = [codes]
        e._n = len(codes)
        e._assign_chunks = [arr("assignments")]
    if "coarse_centers" in manifest["arrays"]:
        e._centers = arr("coarse_centers")
    if manifest["threshold_coeffs"] is not None:
        e.threshold = np.poly1d(manifest["threshold_coeffs"])
    # v2 one-shot adoption state (consumed by the first _build_cache)
    if "norms" in manifest.get("arrays", []):
        e._norms_cache = arr("norms")
    lm = manifest.get("layout")
    if lm is not None:
        e._layout_v = {
            "n": e._n, "nlist": e.nlist, "headroom": lm["headroom"],
            "cap_v": lm["cap_v"], "nlist_v": lm["nlist_v"],
            "nlist_v_pad": lm["nlist_v_pad"],
        }
        for name in _LAYOUT_ARRAYS:
            e._layout_v[name] = arr("vl_" + name)
    e._bump()
    return e
