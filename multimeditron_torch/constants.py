"""Shared dictionary keys and sentinel values.

Capability parity with the reference's ``model/constants.py:1-16``
(same sample-schema keys so datasets written for the reference load
unchanged). A copy of ``multimeditron_tpu/constants.py``: the port imports
nothing of the JAX package.
"""

NUM_EMBEDDINGS_KEY = "num_embeddings"
POSITION_IDS_KEY = "position_ids"
CONVERSATIONS_KEY = "conversations"
TEXT_KEY = "text"
MODALITIES_KEY = "modalities"
MODALITY_TYPE_KEY = "type"
MODALITY_VALUE_KEY = "value"
TOKEN_RANGE_KEY = "token_range"

# Label value ignored by the cross-entropy loss.
IGNORE_TOKEN_INDEX = -100
