from .run import training, evaluate_model_training
