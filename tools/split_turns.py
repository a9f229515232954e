"""Time builds of the split phase-1 pair in turns on one card.

    python3 -m tools.split_turns OTHER_SOURCE [--variant SOURCE ...] [--out FILE]

OTHER_SOURCE is another version of ``kubeadmiral_tpu_torch/csrc/phase1.cu``
(for example an earlier commit's, unpacked with ``git archive``); each
``--variant`` one more (a copy of this checkout's with a constant
changed, say).  All are built with ``ops/phase1.py``'s flags.  On the
blocks chip_smoke.py times — the first half of the first chunk's rows,
the first of two column blocks, at c5's width (2,048 x 2,560 x 3) and
c3's (2,048 x 256 x 2) — the script:

* prints each build's ptxas registers, shared memory and spills;
* compares each build's SASS of the unsplit kernels (``columns_kernel``,
  ``phase1_kernel``) with OTHER_SOURCE's, instruction by instruction;
* holds each build's pair against its plain twins and the joined blocks
  against ``phase1_plain`` on the whole rows (tolerance 0);
* times each build's partial, finish and pair in turns (other, this,
  the variants, then back in the reverse order) at both widths, with
  ``chip_smoke.timed_ms`` (CUDA events, L2 flushed), beside
  ``chip_smoke.split_bounds`` and the bytes each half moves at the
  card's 32-byte sectors (``sector_bytes``), and the unsplit
  ``kt_phase1`` on the c5 chunk;
* times one 256 MiB device-to-device ``copy_`` as the card's streaming
  rate (a yardstick for the sector bytes' rate, used nowhere else);
* times each build's partial and finish at c5's width once more with
  L2 emptied by a read instead of ``timed_ms``'s write (``clean_ms``),
  which leaves no dirty line for the timed kernel to write back;
* times every build's partial and finish on chip_smoke's ATTRIBUTION
  variants of the c5-width block.

The calls go straight to each library (the wrapper's arguments, with a
column-plane scratch for builds whose partial reads one).  The results
go to stdout and, with ``--out``, as JSON to FILE.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from kubeadmiral_tpu_torch.ops import phase1 as P  # noqa: E402

WIDTHS = ("5", "3")


class Build:
    """One build of a phase1.cu: its library and the pair's calls."""

    def __init__(self, source: Path):
        saved = P.SOURCE
        P.SOURCE = source
        try:
            self.path = P.build()
        finally:
            P.SOURCE = saved
        self.lib = ctypes.CDLL(str(self.path))
        for name, n_ptr, n_int in (("kt_phase1", 21, 3), ("kt_phase1_partial", 22, 3),
                                   ("kt_phase1_finish", 6, 2)):
            fn = getattr(self.lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]

    def ptxas(self) -> list[str]:
        return [line.strip() for line in
                self.path.with_suffix(".ptxas.txt").read_text().splitlines()
                if "Compiling entry" in line or "Used" in line or "spill" in line]

    def _stream(self):
        return torch.cuda.current_stream().cuda_stream

    def whole(self, inp):
        args, outs, (b, c, r) = P._launch_args(inp, inp.api_ok.device)
        cols = torch.empty((2 * r + 3, c), dtype=torch.int64, device=inp.api_ok.device)
        ptrs = [x.data_ptr() for x in (*args, *outs, cols)]
        assert self.lib.kt_phase1(*ptrs, b, c, r, self._stream()) == 0
        return outs

    def partial(self, inp):
        args, outs, (b, c, r) = P._launch_args(inp, inp.api_ok.device)
        cols = torch.empty((2 * r + 3, c), dtype=torch.int64, device=inp.api_ok.device)
        maxima = torch.empty((b, 2), dtype=torch.int32, device=inp.api_ok.device)
        ptrs = [x.data_ptr() for x in (*args, *outs, cols, maxima)]
        assert self.lib.kt_phase1_partial(*ptrs, b, c, r, self._stream()) == 0
        return (*outs, maxima)

    def finish(self, feasible, score_enabled, taint, affinity, maxima, totals):
        b, c = totals.shape
        ptrs = [x.data_ptr() for x in (feasible.view(torch.uint8), score_enabled.view(torch.uint8),
                                       taint, affinity, maxima, totals)]
        assert self.lib.kt_phase1_finish(*ptrs, b, c, self._stream()) == 0
        return totals


def sector_bytes(blk, feasible) -> dict:
    """Bytes each half of the pair moves on block ``blk`` at the card's
    32-byte sectors: the partial reads every mask plane its rows enable,
    the webhook scores of every cell and the normalised score planes'
    sectors that hold a feasible cell of a row that scores them, and
    writes its 13 bytes a cell; the finish reads the feasibility and
    those score sectors again, and reads and writes each totals sector
    (a quad) that holds a feasible cell of a row that normalises."""
    from kubeadmiral_tpu_torch.ops import scores as S

    b, c = feasible.shape
    pad = torch.zeros((b, -c % 8), dtype=torch.bool, device=feasible.device)
    f = torch.cat([feasible, pad], 1)
    s8 = f.view(b, -1, 8).any(-1)
    s4 = f.view(b, -1, 4).any(-1)
    fe, se = blk.filter_enabled, blk.score_enabled
    planes = (1 + fe[:, 0].long() + fe[:, 4].long() + 2 * fe[:, 1].long()
              + (fe[:, 3] & blk.placement_has).long())
    scored = se[:, S.S_TAINT].long() + se[:, S.S_AFFINITY].long()
    norm = (scored > 0)[:, None]
    score_sectors = int((s8.long().sum(1) * scored).sum()) * 32
    partial = int(planes.sum()) * c + 4 * b * c + score_sectors + 13 * b * c
    finish = b * c + score_sectors + int((s4 & norm).sum()) * 64
    return {"partial": partial, "finish": finish}


def copy_rate() -> dict:
    """One 256 MiB device-to-device copy_, timed as the pair is: bytes
    read and written over its time."""
    src = torch.ones(256 << 20, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    ms = cs.timed_ms(lambda: dst.copy_(src))
    return {"bytes": 2 * src.numel(), "ms": ms, "tb_per_s": 2 * src.numel() / ms / 1e9}


def clean_ms(fn, runs: int = 7) -> float:
    """chip_smoke.timed_ms with the 256 MiB flush read (a sum) instead of
    written: L2 holds clean lines when fn starts."""
    flush = torch.ones(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for _ in range(runs):
        flush.sum(dtype=torch.int64)
        torch.cuda._sleep(cs.HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(sorted(times)[len(times) // 2])


def sass(build: Build) -> dict:
    """The unsplit kernels' SASS by kernel (template arguments a split
    flag of false may have added dropped), addresses and encodings out."""
    cuobjdump = Path(P._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-sass", str(build.path)], capture_output=True,
                         text=True, check=True).stdout
    kernels, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : \S*?((?:phase1|columns)_kernel\S*)", line)
        if m or "Function :" in line:
            # The kernel's own mangled part: the anonymous namespace's
            # name holds the source file's.
            name = m and re.sub(r"(ILi\dELb\dELb\d)ELb0E", r"\1E", m.group(1))
            if name:
                kernels[name] = []
            continue
        if name and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            kernels[name].append(re.sub(r"/\*[^*]*\*/|;", "", line).split())
    return kernels


def blocks(cfg: str):
    """chip_smoke.py's block at config ``cfg``'s width, its chunk and the
    blocks of its rows."""
    from kubeadmiral_tpu_torch.parallel.mesh import row_bounds
    from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine
    from kubeadmiral_tpu_torch.testing.worlds import SHAPES, build_world

    units, clusters, _ = build_world(8192, SHAPES[cfg][1], config=cfg, seed=0)
    inp, _, _ = cs.chunk_tick_inputs(SchedulerEngine(mesh=None), units, clusters)
    b = inp.total.shape[0]
    lo, hi = row_bounds(b, 2)[0]
    shard = inp._replace(**{k: v[lo:hi] for k, v in inp._asdict().items() if v.shape[:1] == (b,)})
    return inp, shard, cs.split_blocks(shard, 2)


def check(build: Build, shard, pieces) -> int:
    """The pair over ``pieces`` against the plain twins and the joined
    blocks against phase1_plain on the whole rows: the largest
    difference (0 expected)."""
    err = 0

    def diff(a, b):
        assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0

    parts = [build.partial(p) for p in pieces]
    plains = [P.phase1_partial_plain(p) for p in pieces]
    for got, want in zip(parts, plains):
        err = max(err, *(diff(g, w) for g, w in zip(got, want)))
    maxima = torch.stack([p[3] for p in parts]).amax(dim=0)
    totals = [build.finish(p[0], blk.score_enabled, blk.taint_counts, blk.affinity_scores,
                           maxima, p[2]) for p, blk in zip(parts, pieces)]
    whole = P.phase1_plain(shard)
    err = max(err, diff(torch.cat([p[0] for p in parts], 1), whole[0]),
              diff(torch.cat([p[1] for p in parts], 1), whole[1]),
              diff(torch.cat(totals, 1), whole[2]))
    torch.cuda.synchronize()
    return err


def pair_times(build: Build, pieces) -> dict:
    """Partial, finish (given the rows' maxima over both blocks) and the
    pair on the first block, ms."""
    blk = pieces[0]
    maxima = torch.stack([build.partial(p)[3] for p in pieces]).amax(dim=0)
    part = build.partial(blk)
    tot = part[2].clone()

    def pair():
        q = build.partial(blk)
        build.finish(q[0], blk.score_enabled, blk.taint_counts, blk.affinity_scores, maxima, q[2])

    return {
        "partial_ms": cs.timed_ms(lambda: build.partial(blk)),
        "finish_ms": cs.timed_ms(lambda: build.finish(
            part[0], blk.score_enabled, blk.taint_counts, blk.affinity_scores, maxima, tot)),
        "pair_ms": cs.timed_ms(pair),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="the other phase1.cu")
    ap.add_argument("--variant", type=Path, action="append", default=[],
                    help="one more phase1.cu, timed in the same turns")
    ap.add_argument("--out", type=Path, help="also write the results as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("split_turns: needs a CUDA card", file=sys.stderr)
        return 2
    card = cs.card_line()
    cs.log(f"card: {card}")
    builds = {"other": Build(args.other.resolve()), "this": Build(P.SOURCE)}
    for v in args.variant:
        builds[v.stem] = Build(v.resolve())
    names = list(builds)
    turns = names + names[::-1]
    result = {"card": card, "copy": copy_rate(), "ptxas": {k: b.ptxas() for k, b in builds.items()}}
    cs.log(f"copy: {json.dumps(result['copy'])}")
    for k, lines in result["ptxas"].items():
        cs.log(f"ptxas {k}:\n  " + "\n  ".join(lines))
    sass_other = sass(builds["other"])
    result["sass_unsplit"] = {}
    for k in names[1:]:
        mine = sass(builds[k])
        result["sass_unsplit"][k] = {
            name: ("same" if sass_other.get(name) == code else
                   f"differs ({len(sass_other.get(name) or [])} vs {len(code)} instructions, "
                   f"{sum(a != b for a, b in zip(sass_other.get(name) or [], code))} unequal)")
            for name, code in mine.items()
        }
        cs.log(f"sass of the unsplit kernels, {k}: {json.dumps(result['sass_unsplit'][k])}")

    for cfg in WIDTHS:
        chunk, shard, pieces = blocks(cfg)
        blk = pieces[0]
        row = {"shape": [*blk.api_ok.shape, int(blk.request.shape[1])]}
        row["max_abs_err"] = {k: check(b, shard, pieces) for k, b in builds.items()}
        if any(row["max_abs_err"].values()):
            raise AssertionError(f"c{cfg}: the pair differs: {row['max_abs_err']}")
        feas = P.phase1_partial_plain(blk)[0]
        row["bounds"] = {k: {"bound_ms": v["bound_ms"], "bytes": v["bytes"]}
                         for k, v in cs.split_bounds(blk, feas).items()}
        row["sector_bytes"] = sector_bytes(blk, feas)
        row["turns"] = [{"build": k, **pair_times(builds[k], pieces)} for k in turns]
        if cfg == "5":
            maxima = {k: torch.stack([b.partial(p)[3] for p in pieces]).amax(dim=0)
                      for k, b in builds.items()}
            row["clean_flush"] = []
            for k in turns:
                b, part = builds[k], builds[k].partial(blk)
                tot = part[2].clone()
                row["clean_flush"].append({
                    "build": k,
                    "partial_ms": clean_ms(lambda: b.partial(blk)),
                    "finish_ms": clean_ms(lambda: b.finish(part[0], blk.score_enabled,
                                                           blk.taint_counts, blk.affinity_scores,
                                                           maxima[k], tot)),
                })
            row["kt_phase1_chunk_ms"] = [
                {"build": k, "ms": cs.timed_ms(lambda: builds[k].whole(chunk))} for k in turns]
            row["attribution"] = {}
            for key, what, filters_off, scores_off in cs.ATTRIBUTION:
                fe, se = blk.filter_enabled.clone(), blk.score_enabled.clone()
                fe[:, list(filters_off)] = False
                se[:, list(scores_off)] = False
                variant = blk._replace(filter_enabled=fe, score_enabled=se)
                vp = [variant, pieces[1]._replace(filter_enabled=fe, score_enabled=se)]
                bounds = cs.split_bounds(variant, P.phase1_partial_plain(variant)[0])
                row["attribution"][key] = {
                    "what": what,
                    "bound_ms": {k: v["bound_ms"] for k, v in bounds.items()},
                    "turns": [{"build": k, **pair_times(builds[k], vp)} for k in turns],
                }
        result[f"c{cfg}"] = row
        cs.log(f"split turns c{cfg}: {json.dumps(row)}")
        del chunk, shard, pieces, blk
        torch.cuda.empty_cache()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
