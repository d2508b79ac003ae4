"""AdamW with learning-rate schedules and global-norm clipping, and
int8 gradient compression with error feedback (counterparts of
``repro/optim``)."""
