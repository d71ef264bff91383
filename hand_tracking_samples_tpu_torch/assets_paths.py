"""Default asset locations: the repo's assets/ directory, read in place."""
import os

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(_REPO, "assets")

DEFAULT_MODEL_JSON = os.path.join(ASSETS, "model_hand.json")
DEFAULT_ANIMBANK = os.path.join(ASSETS, "animbank.pose")
# the trained pose-initialiser nets, best first (the JAX package's order:
# assets_paths.py:20-28); HTS_CNNB overrides
_PREFERRED = ("handposedd_synth_v4.cnnb", "handposedd_synth_v3.cnnb",
              "handposedd_synth_v2.cnnb", "handposedd_synth.cnnb")
DEFAULT_CNNB = os.environ.get("HTS_CNNB") or next(
    (os.path.join(ASSETS, n) for n in _PREFERRED
     if os.path.exists(os.path.join(ASSETS, n))),
    os.path.join(ASSETS, "handposedd_synth.cnnb"))
