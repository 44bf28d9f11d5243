# Copy of jenga_tpu/batch.py, kept so that the port never imports it.
"""Batched prompt-list generation with resume (VBench-style evaluation).

Counterpart of the reference's JSON prompt-list machinery
(the reference's `jenga_wan.py:947-981`): a JSON file of
``{"prompt_en": ..., "id": ...}`` items (or a plain text file, one prompt
per line), an optional ``remain_list`` JSON of ids to re-run, poor-man's
data parallelism via ``prompts[cur_id::chunk_num]`` host sharding, and
id-stamped outputs that let an interrupted run resume by skipping files
that already exist.
"""

from __future__ import annotations

import json
import os

__all__ = ["load_prompt_list", "load_vbench_info", "run_batch",
           "run_vbench_batch", "vbench_filename"]


def load_prompt_list(path: str, remain_list: str | None = None,
                     chunk_num: int = 1, cur_id: int = 0):
    """Returns a list of (id, prompt) pairs.

    JSON files use the VBench format (``prompt_en`` + optional ``id``);
    anything else is read as one prompt per line. ``remain_list`` is a JSON
    list of integer ids to keep (the reference's resume filter,
    the reference's `jenga_wan.py:953-957`). ``cur_id``/``chunk_num``
    stride-shard the list across hosts.
    """
    prompts, ids = [], []
    if path.endswith(".json"):
        with open(path) as f:
            data = json.load(f)
        if remain_list is not None:
            with open(remain_list) as f:
                keep = set(json.load(f))
            data = [item for item in data if int(item["id"]) in keep]
        for item in data:
            if isinstance(item, dict) and "prompt_en" in item:
                prompts.append(item["prompt_en"])
                ids.append(str(item["id"]).zfill(4) if "id" in item
                           else f"{len(ids):04d}")
    else:
        with open(path) as f:
            prompts = [line.strip() for line in f if line.strip()]
        ids = [f"{i:04d}" for i in range(len(prompts))]
    return list(zip(ids[cur_id::chunk_num], prompts[cur_id::chunk_num]))


def load_vbench_info(path: str, dimension: str | None = None,
                     chunk_num: int = 1, cur_id: int = 0):
    """Load a VBench ``full_info.json``-style file: a list of
    ``{"prompt_en": ..., "dimension": [...]}`` records.

    Returns a list of ``{"prompt": str, "dimensions": [str, ...]}`` dicts,
    optionally filtered to prompts tagged with ``dimension`` and stride-
    sharded across hosts like :func:`load_prompt_list`. This is the input
    side of the standard VBench evaluation protocol (the reference feeds
    the same JSONs through its id-based loader,
    the reference's `jenga_wan.py:950-972`; dimension tags ride along here
    so the output naming below is turnkey for ``vbench evaluate``).
    """
    with open(path) as f:
        data = json.load(f)
    items = []
    for rec in data:
        if not (isinstance(rec, dict) and "prompt_en" in rec):
            continue
        dims = list(rec.get("dimension", []))
        if dimension is not None and dimension not in dims:
            continue
        items.append({"prompt": rec["prompt_en"], "dimensions": dims})
    return items[cur_id::chunk_num]


def vbench_filename(prompt: str, sample_idx: int, suffix: str = ".mp4"):
    """The standard VBench sampled-video name: ``{prompt}-{index}{ext}``.

    VBench's evaluator locates each prompt's samples by this exact
    convention (prompt text verbatim, ``-0..-4`` sample indices). Only
    path separators are replaced (they would escape the output dir);
    everything else is kept verbatim as the protocol requires.
    """
    safe = prompt.replace("/", " ").replace("\x00", "")
    return f"{safe}-{sample_idx}{suffix}"


def run_vbench_batch(infos, generate_fn, save_fn, out_dir: str,
                     samples_per_prompt: int = 5, suffix: str = ".mp4",
                     skip_existing: bool = True, log=print, seed: int = 0):
    """VBench-protocol sampling loop: ``samples_per_prompt`` videos per
    prompt (the protocol's 5), named ``{prompt}-{i}{suffix}`` so a
    ``vbench evaluate --videos_path out_dir`` run needs no renaming.

    ``generate_fn(prompt, seed)`` is called with a distinct deterministic
    seed per sample (``seed + i``); existing files are skipped for resume.
    Returns (prompt, path, status) triples.
    """
    os.makedirs(out_dir, exist_ok=True)
    results = []
    for info in infos:
        prompt = info["prompt"] if isinstance(info, dict) else str(info)
        for i in range(samples_per_prompt):
            path = os.path.join(out_dir, vbench_filename(prompt, i, suffix))
            if skip_existing and os.path.exists(path):
                log(f"[vbench] exists, skipping: {os.path.basename(path)}")
                results.append((prompt, path, "skipped"))
                continue
            try:
                out = generate_fn(prompt, seed + i)
                save_fn(path, out)
                log(f"[vbench] saved {os.path.basename(path)}")
                results.append((prompt, path, "ok"))
            except Exception as e:  # noqa: BLE001 - batch isolation
                log(f"[vbench] FAILED {prompt!r}#{i}: "
                    f"{type(e).__name__}: {e}")
                results.append((prompt, path, f"error: {e}"))
    return results


def run_batch(items, generate_fn, save_fn, out_dir: str,
              suffix: str = ".mp4", skip_existing: bool = True,
              log=print, seed=None):
    """Run ``generate_fn(prompt)`` per (id, prompt), saving via
    ``save_fn(path, output)``.

    Output names follow the reference convention
    (the reference's `jenga_wan.py:1114-1119`): the id prefix keeps
    existence-based resume deterministic, the rest stamps time/seed/
    prompt-slug. Existing ``{id}_*`` outputs are skipped (resume);
    failures are logged and the run continues so one bad prompt never
    loses a batch. Returns the list of (id, path, status) triples.
    """
    import glob as _glob

    from .utils.logging import stamp_filename

    os.makedirs(out_dir, exist_ok=True)
    results = []
    for vid, prompt in items:
        path = os.path.join(out_dir, f"{vid}_" + stamp_filename(
            prompt, 0 if seed is None else seed, ext=suffix.lstrip(".")))
        legacy = os.path.join(out_dir, f"{vid}{suffix}")
        # ids come from arbitrary JSON: escape them so glob metacharacters
        # can't false-match another id or miss this one; anchor the match
        # on the stamp format (`{id}_<YYYYMMDD-HHMMSS>_seed...`) so an id
        # that is an underscore-prefix of another (id "a" vs files of id
        # "a_b") never false-matches and silently skips a prompt
        import re as _re
        stamp_re = _re.compile(
            _re.escape(f"{vid}_") + r"\d{8}-\d{6}_seed")
        stamped = [
            f for f in _glob.glob(os.path.join(
                _glob.escape(out_dir), _glob.escape(f"{vid}_")
                + f"*{suffix}"))
            if stamp_re.match(os.path.basename(f))
        ]
        done = ([legacy] if os.path.exists(legacy) else []) + stamped
        if skip_existing and done:
            log(f"[{vid}] exists, skipping")
            # return the on-disk path that triggered the skip, not the
            # would-be freshly stamped name (which does not exist)
            results.append((vid, done[0], "skipped"))
            continue
        try:
            out = generate_fn(prompt)
            save_fn(path, out)
            log(f"[{vid}] saved {path}")
            results.append((vid, path, "ok"))
        except Exception as e:  # noqa: BLE001 - batch isolation by design
            log(f"[{vid}] FAILED: {type(e).__name__}: {e}")
            results.append((vid, path, f"error: {e}"))
    return results
