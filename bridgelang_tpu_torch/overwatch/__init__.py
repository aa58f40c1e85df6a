from bridgelang_tpu_torch.overwatch.overwatch import Overwatch, initialize_overwatch

__all__ = ["Overwatch", "initialize_overwatch"]
