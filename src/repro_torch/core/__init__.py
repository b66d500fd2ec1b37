"""ELSA's channel: SS-OP (:mod:`.ssop`), the count sketch (:mod:`.sketch`)
and the split-training channel that chains them (:mod:`.split_training`)."""
