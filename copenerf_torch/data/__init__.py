from .dataloading import OurDataset, get_dataloader
from .fields import DataField, get_data_fields
