"""Training: LR schedules, EMA, losses and the train step, and the
text-to-image trainer (`train_text_to_image`)."""
