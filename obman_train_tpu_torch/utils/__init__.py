from obman_train_tpu_torch.utils.logging import Monitor, TrainLogger, parse_log_line

__all__ = ["Monitor", "TrainLogger", "parse_log_line"]
