"""Training: the train step (`train_step`) and the fault-tolerant loop (`trainer`)."""
