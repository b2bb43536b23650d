"""Provenance stamps (a copy of unetseg_tpu/utils/provenance.py): the
short content hash of the shipped recipe, which result writers stamp
beside recorded evaluations so a reader can tell whether a stamp still
describes configs/best_recipe.json."""

import hashlib
import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def recipe_hash(path: str = "") -> str:
    """Short content hash of configs/best_recipe.json ('' if absent)."""
    path = path or os.path.join(REPO, "configs", "best_recipe.json")
    try:
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()[:12]
    except OSError:
        return ""
