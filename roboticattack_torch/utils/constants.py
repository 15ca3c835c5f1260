"""Shared numeric constants of the OpenVLA stack.

These pin down the token-space geometry and image statistics the whole
framework relies on (the same values as the JAX package's
`utils/constants.py`, which names their upstream provenance).
"""

# --- Token space -------------------------------------------------------------
VOCAB_SIZE = 32000            # Llama-2 tokenizer vocab (excludes added PAD)
PAD_TO_MULTIPLE_OF = 64
PADDED_VOCAB_SIZE = 32064     # embedding rows in the OpenVLA checkpoint
PAD_TOKEN_ID = 32000
BOS_TOKEN_ID = 1
EOS_TOKEN_ID = 2
EMPTY_TOKEN_ID = 29871        # SentencePiece "empty" token appended after "Out:"
IGNORE_INDEX = -100

# --- Action discretization ---------------------------------------------------
N_ACTION_BINS = 256
ACTION_DIM = 7
# token id of action value a: VOCAB_SIZE - digitize(a, linspace(-1, 1, 256))
ACTION_TOKEN_BEGIN_IDX = VOCAB_SIZE - (N_ACTION_BINS + 1)   # 31743 (exclusive lower bound)
ACTION_TOKEN_MIN = 31744      # action ~= +1 (highest bin)
ACTION_TOKEN_ZERO = 31872     # action ~= 0
ACTION_TOKEN_MAX = 31999      # action ~= -1 (lowest bin)

# --- Image statistics (bf16-rounded, matching the reference exactly) ---------
DINO_MEAN = (0.484375, 0.455078125, 0.40625)
DINO_STD = (0.228515625, 0.2236328125, 0.224609375)
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)

IMAGE_SIZE = 224
VIT_PATCH_SIZE = 14
NUM_VISION_PATCHES = (IMAGE_SIZE // VIT_PATCH_SIZE) ** 2    # 256

# --- Patch sizes (side length -> ~area fraction of 224x224) ------------------
PATCH_SIZE_BY_AREA_PCT = {1: 22, 5: 50, 10: 70, 15: 87, 20: 100}

# --- Compositing sentinels ---------------------------------------------------
CANVAS_FILL = -100.0          # off-patch canvas value before compositing
COMPOSITE_THRESHOLD = -20.0   # canvas < threshold -> keep background pixel
