from ever_tpu_torch.metric import function  # noqa: F401
from ever_tpu_torch.metric.confusion_matrix import ConfusionMatrix  # noqa: F401
from ever_tpu_torch.metric.evaluate_fn import (  # noqa: F401
    distributed_evaluate_pixel_prediction_task,
    evaluate_change_detection_task,
    evaluate_damage_assessment_task,
    evaluate_pixel_prediction_task,
)
from ever_tpu_torch.metric.function import (  # noqa: F401
    average_accuracy_score,
    cohen_kappa_score,
    confusion_matrix,
    iou_per_class,
    mean_iou,
    overall_accuracy_score,
    th_confusion_matrix,
)
from ever_tpu_torch.metric.pixel import AccTable, PixelMetric  # noqa: F401
from ever_tpu_torch.metric.utils import ScoreTracker  # noqa: F401
