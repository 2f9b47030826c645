from .records import (
    RecordLoader,
    RecordMeta,
    RecordShardWriter,
    read_record,
    scan_label_lengths,
    scan_scp,
)
from .pipeline import (
    splice_frames,
    subsample_frames,
    BucketedBatcher,
    iterate_batches,
    iterate_utterances,
)
