"""Training and evaluation: the finetune model builder, train and eval
steps, the epoch loop, metrics, checkpoints and the refiner presets."""
