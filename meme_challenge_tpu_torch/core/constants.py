"""Framework-wide constants.

A copy of ``meme_challenge_tpu/core/constants.py``.

Parity: reference utils/const.py:1-4 (IMG_DIM/IMG_DIM_OSCAR/IMG_LABEL_DIM).
POS_DIM is the 7-d bbox position encoding (x1,y1,x2,y2,w,h,w*h) built in
reference data/dataset_template.py:98-113.
"""

IMG_DIM = 2048          # bottom-up-attention region feature dim
IMG_DIM_OSCAR = 2054    # Oscar: 2048 features + 6-d bbox geometry appended
IMG_LABEL_DIM = 1601    # Visual-Genome object classes (incl. background) for MRC
POS_DIM = 7             # (x1, y1, x2, y2, w, h, w*h), normalized to image size

# Static-shape defaults (reference train_uniter.py:98-107 flags).
MAX_TXT_LEN = 60        # max BERT BPE tokens per meme text
MAX_BB = 100            # max region boxes per image
MIN_BB = 10             # min region boxes kept by the extractor
NUM_BB_FIXED = 36       # fixed-box extraction mode
BUCKET_SIZE = 8192        # id-bucketing constant carried from reference utils/const.py:4
