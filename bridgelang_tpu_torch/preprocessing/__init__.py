from bridgelang_tpu_torch.preprocessing.materialize import get_dataset_and_collator

__all__ = ["get_dataset_and_collator"]
