"""Default asset locations: the repo's assets/ directory, read in place."""
import os

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(_REPO, "assets")

DEFAULT_MODEL_JSON = os.path.join(ASSETS, "model_hand.json")
DEFAULT_ANIMBANK = os.path.join(ASSETS, "animbank.pose")
